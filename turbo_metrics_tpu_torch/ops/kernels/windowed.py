"""Kernel #11: one SSIM level's windowed sums, with the next MS-SSIM level.

``ssim_sums`` launches ``tm_ssim_level`` (csrc/windowed.cu) on a CUDA tensor
and runs its plain twin ``ssim_sums_ref`` on a CPU tensor.  It replaces the
JAX package's ``ssim_sums_pallas`` (turbo_metrics_tpu/ops/pallas/windowed.py:
400) as ``ssim_level_padded`` (l.547) and ``msssim_level_means_padded``
(l.582) call it: per channel the sums of luminance*cs and of cs over the
valid grid, optionally quantizing the level to 8-bit code values at load,
optionally emitting the truncating 2x2 mean (the semantics of
``_emit_halfpool_tiles``, l.94) as the next MS-SSIM level.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import quality
from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W, check_level

WINDOW = 2 * quality.RADIUS + 1


def check_ssim_level(q12: torch.Tensor, window: torch.Tensor) -> None:
    check_level(q12)
    if min(q12.shape[-2], q12.shape[-1]) < WINDOW:
        raise ValueError(f"an SSIM level must be at least {WINDOW}x{WINDOW}, got {tuple(q12.shape)}")
    if (
        window.shape != (WINDOW,) or window.dtype != torch.float32
        or window.device != q12.device or not window.is_contiguous()
    ):
        raise ValueError(f"window must be a contiguous ({WINDOW},) float32 tensor on {q12.device}")


def ssim_sums_ref(q12, window, *, quantize=False, emit_ds=False, c1=quality.C1, c2=quality.C2):
    """Plain twin of ``ssim_sums`` (same arguments and results): the jnp
    formulation (five blurs), sums in f64."""
    q = f32_to_uint8(q12, torch.float32) if quantize else q12
    lum, cs = quality._ssim_parts(q[0], q[1], window, c1, c2)
    sums = torch.stack(
        [(lum * cs).double().sum(dim=(-2, -1)), cs.double().sum(dim=(-2, -1))], dim=-1
    ).float()
    return sums, (quality._downsample_2x2(q) if emit_ds else None)


def ssim_sums(
    q12: torch.Tensor,
    window: torch.Tensor,
    *,
    quantize: bool = False,
    emit_ds: bool = False,
    c1: float = quality.C1,
    c2: float = quality.C2,
):
    """Per-channel (sum(luminance*cs), sum(cs)) of one SSIM level.

    ``q12``: contiguous (2, B, 3, h, w) f32 (reference, distorted), 8-bit
    code values, or with ``quantize`` linear RGB in [0, 1] quantized at load
    (clip(round(x*255), 0, 255), half to even).  ``window``: the (11,) f32
    taps on the same device.  Returns ((B, 3, 2) f32 sums over the (h-10) x
    (w-10) valid grid, the next level (2, B, 3, h//2, w//2) f32 of the
    (quantized) values with ``emit_ds``, else None).
    """
    check_ssim_level(q12, window)
    if q12.device.type == "cpu":
        return ssim_sums_ref(q12, window, quantize=quantize, emit_ds=emit_ds, c1=c1, c2=c2)
    if q12.device.type != "cuda":
        raise ValueError(f"ssim_sums runs on cuda or cpu, not {q12.device}")
    lib = LIBRARY.get()
    _, bsz, _, h, w = q12.shape
    dev = q12.device
    sums = torch.empty((bsz, 3, 2), dtype=torch.float32, device=dev)
    ds = (
        torch.empty((2, bsz, 3, h // 2, w // 2), dtype=torch.float32, device=dev)
        if emit_ds else None
    )
    launch_level(lib, q12, window, quantize, c1, c2, sums, 6, ds)
    ssim_sums.launches += 1
    return sums, ds


ssim_sums.launches = 0


def launch_level(lib, q12, window, quantize, c1, c2, sums, sums_bstride, ds, parts=None):
    """One ``tm_ssim_level`` call on the current stream.  ``parts``: the
    partials of a level at least this large (``level_scratch``; allocated
    here when None)."""
    _, bsz, _, h, w = q12.shape
    if parts is None:
        parts = level_scratch(bsz, h, w, q12.device)
    with launch_stream(q12.device) as stream:
        check(
            lib.tm_ssim_level(
                q12.data_ptr(), bsz, h, w, int(quantize), window.data_ptr(), float(c1), float(c2),
                parts.data_ptr(), sums.data_ptr(), sums_bstride,
                ds.data_ptr() if ds is not None else None,
                stream,
            ),
            "tm_ssim_level",
        )


def ssim_blocks(h: int, w: int) -> int:
    """Partial tiles per (batch, channel) plane of an h x w level: the 32x8
    tiles (PART_W x PART_H) of its (h-10) x (w-10) valid grid, the count of
    ``tm_ssim_blocks`` (csrc/windowed.cu)."""
    return -(-(w - WINDOW + 1) // PART_W) * -(-(h - WINDOW + 1) // PART_H)


def level_scratch(bsz: int, h: int, w: int, dev) -> torch.Tensor:
    """The two f32 partials of every 32x8 tile of B*3 planes of an h x w
    level: the level's only scratch, since the tile kernel keeps its
    row-correlated planes in shared memory."""
    return torch.empty(bsz * 3 * ssim_blocks(h, w) * 2, dtype=torch.float32, device=dev)
