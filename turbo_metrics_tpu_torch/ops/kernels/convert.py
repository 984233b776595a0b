"""Kernel #6: YUV 4:2:0 -> clamped linear RGB into the (2, B, 3, h, w) pair
buffer that the multi-metric path reads.

``yuv420_to_linear_rgb_pair`` launches ``tm_yuv420_to_rgb``
(csrc/convert.cu) on a CUDA tensor and runs its plain twin
``yuv420_to_linear_rgb_pair_ref`` on a CPU tensor.  It replaces the JAX
package's ``_convert_padded_impl``
(turbo_metrics_tpu/ops/pallas/convert.py:404), reached there through
``yuv420_pair_to_linear_rgb_padded`` (both images of a pair sharing one
conversion spec, one launch) and ``yuv420_to_linear_rgb_padded`` (one image
into its slot, for a pair whose specs differ).  The buffer is contiguous and
unpadded: its consumers mask their own borders.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import TRANSFER_CODES, check_yuv


def _check(y, uv, out, slot, depth, transfer):
    if slot is not None and (slot not in (0, 1) or out is None):
        raise ValueError("slot must be 0 or 1, with the pair buffer as out")
    check_yuv(y, uv, depth, transfer, pair=slot is None)
    bsz, h, w = y.shape[-3:]
    if out is not None:
        if tuple(out.shape) != (2, bsz, 3, h, w) or out.dtype != torch.float32:
            raise ValueError(f"out must be (2, {bsz}, 3, {h}, {w}) float32, got "
                             f"{tuple(out.shape)} {out.dtype}")
        if out.device != y.device or not out.is_contiguous():
            raise ValueError(f"out must be contiguous on {y.device}")
    return bsz, h, w


def yuv420_to_linear_rgb_pair_ref(
    y, uv, out=None, slot=None, *, depth=8, matrix="bt709", transfer="bt709",
    full_range=False, kr_kb=None,
):
    """Plain twin of ``yuv420_to_linear_rgb_pair`` (same arguments and result)."""
    bsz, h, w = _check(y, uv, out, slot, depth, transfer)
    lin = colorspace.yuv420_to_linear_rgb(
        y, uv, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, kr_kb=kr_kb,
    )
    if slot is None:
        if out is None:
            return lin
        out.copy_(lin)
        return out
    out[slot].copy_(lin)
    return out


def yuv420_to_linear_rgb_pair(
    y: torch.Tensor,
    uv: torch.Tensor,
    out: torch.Tensor | None = None,
    slot: int | None = None,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    kr_kb=None,
) -> torch.Tensor:
    """Clamped linear RGB of a frame pair, (2, B, 3, h, w) f32.

    Without ``slot``: ``y`` (2, B, h, w) and ``uv`` (2, B, ceil(h/2),
    ceil(w/2), 2) hold both images (reference, distorted) of one conversion
    spec; the result is ``out`` if given, else a new buffer.  With ``slot``
    0 or 1: ``y`` (B, h, w) and ``uv`` (B, ...) hold one image, converted
    into ``out[slot]`` (a pair whose two inputs differ in depth, range or
    colour).  Planes are uint8 at 8 bits, else uint16.
    """
    bsz, h, w = _check(y, uv, out, slot, depth, transfer)
    if y.device.type == "cpu":
        return yuv420_to_linear_rgb_pair_ref(
            y, uv, out, slot, depth=depth, matrix=matrix, transfer=transfer,
            full_range=full_range, kr_kb=kr_kb,
        )
    if y.device.type != "cuda":
        raise ValueError(f"yuv420_to_linear_rgb_pair runs on cuda or cpu, not {y.device}")
    lib = LIBRARY.get()
    if out is None:
        out = torch.empty((2, bsz, 3, h, w), dtype=torch.float32, device=y.device)
    rng = colorspace.sample_range(depth, full_range)
    coeffs = colorspace.conversion_coeffs(depth, matrix, full_range, kr_kb)
    dst = out if slot is None else out[slot]
    check(
        lib.tm_yuv420_to_rgb(
            y.data_ptr(), uv.data_ptr(), int(depth > 8),
            bsz * (2 if slot is None else 1), h, w, *coeffs,
            float(rng.minimum), float(rng.neutral), TRANSFER_CODES[transfer],
            dst.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream,
        ),
        "tm_yuv420_to_rgb",
    )
    yuv420_to_linear_rgb_pair.launches += 1
    return out


yuv420_to_linear_rgb_pair.launches = 0
