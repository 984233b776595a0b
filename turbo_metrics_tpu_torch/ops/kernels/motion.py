"""Kernels #16 and #17: VMAF motion's integer blur, with the row SADs.

``motion_stats`` launches ``tm_motion_stats`` and ``integer_blur`` launches
``tm_integer_blur`` (csrc/motion.cu) on a CUDA tensor; on a CPU tensor each
runs its plain twin (``motion_stats_ref``, ``integer_blur_ref``).  They
replace the JAX package's ``motion_stats_pallas`` and ``integer_blur_pallas``
(turbo_metrics_tpu/ops/pallas/motion.py:180 and :236), whose jnp
counterparts the JAX engine runs: the batch's blur and SAD once per batch,
the blur alone for the first frame of a stream.

Frame b's previous blurred frame is the blur of frame b - 1 of the same
batch; frame 0's is ``prev0``, the plane carried over from the previous
batch (the JAX engine concatenates the same planes).
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import vmaf_motion
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
# The luma types of csrc/motion.cu are those of csrc/xpsnr.cu.
from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES


def _check(y, depth, prev0=None):
    if y.ndim != 3 or min(y.shape[-2:]) < 3:
        raise ValueError(f"y must be (B, h, w) with h, w >= 3, got {tuple(y.shape)}")
    if y.dtype not in DTYPE_CODES:
        raise ValueError(f"y must be uint8, uint16 or int32, got {y.dtype}")
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be 1-16 bits, got {depth}")
    if prev0 is not None:
        if prev0.shape != y.shape[1:] or prev0.dtype != torch.uint16:
            raise ValueError(
                f"prev0 must be a {tuple(y.shape[1:])} uint16 plane, got "
                f"{tuple(prev0.shape)} {prev0.dtype}"
            )
        if prev0.device != y.device or not prev0.is_contiguous():
            raise ValueError("prev0 must be contiguous, on y's device")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")


def _device(y, name):
    if y.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {y.device}")


def integer_blur_ref(y, *, depth=8):
    """Plain twin of ``integer_blur`` (same arguments and result)."""
    _check(y, depth)
    return vmaf_motion.integer_blur(y, depth=depth)


def integer_blur(y: torch.Tensor, *, depth: int = 8) -> torch.Tensor:
    """The exact integer 5-tap blur of (B, h, w) luma at ``depth`` bits ->
    (B, h, w) uint16."""
    _check(y, depth)
    if y.device.type == "cpu":
        return integer_blur_ref(y, depth=depth)
    _device(y, "integer_blur")
    lib = LIBRARY.get()
    bsz, h, w = y.shape
    blurred = torch.empty((bsz, h, w), dtype=torch.uint16, device=y.device)
    with launch_stream(y.device) as stream:
        check(
            lib.tm_integer_blur(y.data_ptr(), DTYPE_CODES[y.dtype], bsz, h, w, depth,
                                blurred.data_ptr(), stream),
            "tm_integer_blur",
        )
    integer_blur.launches += 1
    return blurred


integer_blur.launches = 0


def motion_stats_ref(y, prev0, *, depth=8):
    """Plain twin of ``motion_stats`` (same arguments and results)."""
    _check(y, depth, prev0)
    blurred = vmaf_motion.integer_blur(y, depth=depth)
    # In int64: torch's uint16 tensors take few operations on CUDA.
    prev = torch.cat([prev0[None].to(torch.int64), blurred[:-1].to(torch.int64)])
    return {"blurred": blurred, "sad_rows": vmaf_motion.sad_rows(blurred, prev)}


def motion_stats(y: torch.Tensor, prev0: torch.Tensor, *, depth: int = 8) -> dict:
    """Blur each frame of (B, h, w) luma and SAD it against the previous
    blurred frame (frame b - 1's; ``prev0``, a (h, w) uint16 plane, for
    frame 0).  Returns {'blurred': (B, h, w) uint16, 'sad_rows': (B, h)
    int64 holding the uint32 row sums}."""
    _check(y, depth, prev0)
    if y.device.type == "cpu":
        return motion_stats_ref(y, prev0, depth=depth)
    _device(y, "motion_stats")
    lib = LIBRARY.get()
    bsz, h, w = y.shape
    blurred = torch.empty((bsz, h, w), dtype=torch.uint16, device=y.device)
    sad_rows = torch.empty((bsz, h), dtype=torch.int64, device=y.device)
    with launch_stream(y.device) as stream:
        check(
            lib.tm_motion_stats(y.data_ptr(), DTYPE_CODES[y.dtype], prev0.data_ptr(), bsz, h, w, depth,
                                blurred.data_ptr(), sad_rows.data_ptr(), stream),
            "tm_motion_stats",
        )
    motion_stats.launches += 1
    return {"blurred": blurred, "sad_rows": sad_rows}


motion_stats.launches = 0
