"""VMAF motion feature: the exact integer 5-tap blur and the SAD against the
previous blurred frame.

The port's copy of the JAX package's ops/vmaf_motion.py (the equivalent of
vmaf-cuda-kernel/src/integer_motion.rs:28-92), bit-exact integer math:

    blurred_y(col)  = sum_k F[k] * sample                 (u32)
    tmp             = (blurred_y + 2^(N-1)) >> N
    blurred         = (sum_k F[k] * tmp + 32768) >> 16     (u16)
    sad             = sum |blurred - prev_blurred|

with the reference's asymmetric mirror (reflect on the low edge, symmetric
on the high edge).  These are the plain torch versions: every step runs in
int64 and is masked to 32 bits where the JAX package's uint32 arithmetic
would wrap, so the results are its bit for bit.  The CUDA kernels
(ops/kernels/motion.py) compute the same planes and row sums, and
``integer_blur`` and ``motion_stats`` take them as their JAX namesakes take
the Pallas kernels, by ``backend`` (ops/routes.py: #17 and #16 on a CUDA
tensor, behind JAX's gate and for the kernels' luma types).  JAX runs jnp
by default on every platform, a choice measured on the TPU; on the card
the kernels are the default.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import routes

FILTER = np.array([3571, 16004, 26386, 16004, 3571], dtype=np.uint32)
RADIUS = 2
U32 = 0xFFFFFFFF


def mirror_index(n: int, device=None) -> torch.Tensor:
    """Source indices of the padded axis, -RADIUS .. n+RADIUS-1: 'reflect'
    below 0 (x[-1] = x[1]), 'symmetric' from n on (x[n] = x[n-1])."""
    idx = torch.arange(-RADIUS, n + RADIUS, device=device).abs()
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def kernel_ok(y: torch.Tensor, backend) -> bool:
    """Whether ``y`` takes #16 / #17 under ``backend``: the kernel route,
    (B, h, w) planes whose smaller side is at least 32 (JAX's gate), in a
    luma type of the kernels (uint8, uint16, int32)."""
    from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES

    return routes.kernel_route(backend, y.device) and routes.wide_planes(y) and y.dtype in DTYPE_CODES


def integer_blur(y: torch.Tensor, *, depth: int = 8, backend: str | None = None) -> torch.Tensor:
    """Exact-integer separable 5-tap blur of (..., H, W) luma -> uint16;
    ``backend``: #17 where ``kernel_ok``, else the plain version below."""
    if kernel_ok(y, backend):
        from turbo_metrics_tpu_torch.ops.kernels import motion

        return motion.integer_blur(y.contiguous(), depth=depth)
    h, w = y.shape[-2], y.shape[-1]
    x = y.to(torch.int64)
    xp = x.index_select(-2, mirror_index(h, x.device))
    acc = torch.zeros_like(x)
    for k in range(5):
        acc = (acc + int(FILTER[k]) * xp[..., k : k + h, :]) & U32
    tmp = ((acc + (1 << (depth - 1))) & U32) >> depth
    tp = tmp.index_select(-1, mirror_index(w, x.device))
    acc2 = torch.zeros_like(tmp)
    for k in range(5):
        acc2 = (acc2 + int(FILTER[k]) * tp[..., k : k + w]) & U32
    return (((acc2 + 32768) & U32) >> 16).to(torch.uint16)


def motion_stats(y: torch.Tensor, prev_blurred: torch.Tensor, *, depth: int = 8, backend: str | None = None,
                 columns=None) -> dict:
    """Blur the current luma and SAD it against the previous blurred frame.

    Returns {'blurred': (..., H, W) uint16, 'sad_rows': (..., H) int64
    holding the uint32 row sums} (the host finishes the sums in int64),
    over the columns ``columns`` = (lo, hi) (None: the whole rows).
    ``backend``: where ``kernel_ok``, #16 with every frame's own previous
    plane (``prev_blurred`` uint16, shaped like ``y`` or one (H, W) plane
    for every frame), else the plain version below.
    """
    if kernel_ok(y, backend) and prev_blurred.dtype == torch.uint16 and prev_blurred.shape in (y.shape, y.shape[1:]):
        from turbo_metrics_tpu_torch.ops.kernels import motion

        prev = prev_blurred.contiguous().expand(y.shape)
        return motion.motion_stats(y.contiguous(), prev=prev, depth=depth, columns=columns)
    blurred = integer_blur(y, depth=depth, backend="jnp")
    return {"blurred": blurred, "sad_rows": sad_rows(blurred, prev_blurred, columns)}


def sad_window(columns, w: int) -> tuple[int, int]:
    """The columns [lo, hi) of a w wide row whose SADs are summed:
    ``columns``, or (0, w) for None.  ``ValueError`` unless 0 <= lo <= hi
    <= w."""
    lo, hi = (0, w) if columns is None else (int(c) for c in columns)
    if not 0 <= lo <= hi <= w:
        raise ValueError(f"columns must satisfy 0 <= lo <= hi <= {w}, got {tuple(columns)}")
    return lo, hi


def sad_rows(blurred: torch.Tensor, prev_blurred: torch.Tensor, columns=None) -> torch.Tensor:
    """Per-row sums of |blurred - prev_blurred| (uint32 values in int64),
    over the columns ``sad_window(columns, w)``."""
    diff = (blurred.to(torch.int64) - prev_blurred.to(torch.int64)).abs()
    if columns is not None:
        lo, hi = sad_window(columns, diff.shape[-1])
        diff = diff[..., lo:hi]
    return diff.sum(dim=-1) & U32


def motion_score(sad: int, width: int, height: int, *, depth: int = 8) -> float:
    """SAD -> libvmaf 'motion' score: mean abs diff in 8-bit units.

    The integer blur outputs samples scaled to the 16-bit range regardless of
    source depth (the >>N / >>16 shifts normalise exactly), so the SAD is
    divided by 2^(16-8) = 256 to express motion in 8-bit code values.
    """
    del depth  # blur output scale is depth-independent
    return float(sad) / (width * height) / 256.0
