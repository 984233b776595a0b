"""Kernels #6 and #5: YUV -> clamped linear RGB.

Kernel #6 converts 4:2:0 into the (2, B, 3, h, w) pair buffer that the
multi-metric path reads; kernel #5 (``yuv_to_linear_rgb``, below) converts
4:2:0, 4:2:2 or 4:4:4, for the generic path's other formats.  Both share one
CUDA kernel template and ``csrc/colorspace.cuh``, so they convert
bit-identically.

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
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
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
        full_range=full_range, kr_kb=kr_kb, backend="jnp",
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
    with launch_stream(y.device) as stream:
        check(
            lib.tm_yuv420_to_rgb(
                y.data_ptr(), uv.data_ptr(), int(depth > 8),
                bsz * (2 if slot is None else 1), h, w, *coeffs,
                float(rng.minimum), float(rng.neutral), TRANSFER_CODES[transfer],
                dst.data_ptr(), stream,
            ),
            "tm_yuv420_to_rgb",
        )
    yuv420_to_linear_rgb_pair.launches += 1
    return out


yuv420_to_linear_rgb_pair.launches = 0


def _check_any(y, uv, out, depth, transfer, chroma):
    check_yuv(y, uv, depth, transfer, pair=y.ndim == 4, chroma=chroma)
    h, w = y.shape[-2], y.shape[-1]
    want_out = (*y.shape[:-2], 3, h, w)
    if out is not None and (
        tuple(out.shape) != want_out or out.dtype != torch.float32
        or out.device != y.device or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous {want_out} float32 tensor on {y.device}")
    return h, w, want_out


def yuv_to_linear_rgb_ref(
    y, uv, out=None, *, depth=8, matrix="bt709", transfer="bt709", full_range=False,
    chroma=420, kr_kb=None,
):
    """Plain twin of ``yuv_to_linear_rgb`` (same arguments and result)."""
    _check_any(y, uv, out, depth, transfer, chroma)
    lin = colorspace.yuv420_to_linear_rgb(
        y, uv, depth=depth, matrix=matrix, transfer=transfer, full_range=full_range,
        kr_kb=kr_kb, chroma=chroma, backend="jnp",
    )
    if out is None:
        return lin
    return out.copy_(lin)


def yuv_to_linear_rgb(
    y: torch.Tensor,
    uv: torch.Tensor,
    out: torch.Tensor | None = None,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    chroma: int = 420,
    kr_kb=None,
) -> torch.Tensor:
    """Kernel #5: planar YUV at any subsampling -> clamped linear RGB f32.

    ``y``: (B, h, w) luma, or (2, B, h, w) for both images of a pair, uint8
    at 8 bits else uint16; ``uv``: (..., ch, cw, 2) chroma on the
    ``chroma`` grid (420, 422 or 444, see ``colorspace.chroma_dims``).  The
    result, (..., 3, h, w), is ``out`` if given (e.g. one slot of the pair
    buffer), else a new tensor.  Launches
    ``tm_yuv_to_rgb`` (csrc/convert.cu) once for all images on a CUDA
    tensor; replaces ``yuv420_to_linear_rgb_pallas``
    (turbo_metrics_tpu/ops/pallas/convert.py:125).
    """
    h, w, shape = _check_any(y, uv, out, depth, transfer, chroma)
    if y.device.type == "cpu":
        return yuv_to_linear_rgb_ref(
            y, uv, out, depth=depth, matrix=matrix, transfer=transfer,
            full_range=full_range, chroma=chroma, kr_kb=kr_kb,
        )
    if y.device.type != "cuda":
        raise ValueError(f"yuv_to_linear_rgb runs on cuda or cpu, not {y.device}")
    lib = LIBRARY.get()
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=y.device)
    rng = colorspace.sample_range(depth, full_range)
    coeffs = colorspace.conversion_coeffs(depth, matrix, full_range, kr_kb)
    with launch_stream(y.device) as stream:
        check(
            lib.tm_yuv_to_rgb(
                y.data_ptr(), uv.data_ptr(), int(depth > 8), int(chroma), y.numel() // (h * w),
                h, w, *coeffs, float(rng.minimum), float(rng.neutral), TRANSFER_CODES[transfer],
                out.data_ptr(), stream,
            ),
            "tm_yuv_to_rgb",
        )
    yuv_to_linear_rgb.launches += 1
    return out


yuv_to_linear_rgb.launches = 0
