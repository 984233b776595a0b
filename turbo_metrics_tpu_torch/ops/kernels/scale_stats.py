"""Kernels 1 and #3: one SSIMULACRA2 pyramid level, from YUV or linear RGB.

``fused_scale0_yuv`` (kernel 1) launches the CUDA kernels of
csrc/ssimulacra2_scale.cu (``tm_yuv420_to_xyb`` + ``tm_level_sums``) on a
CUDA tensor, and runs its plain twin ``fused_scale0_yuv_ref`` on a CPU
tensor.  It replaces the JAX package's ``fused_scale0_yuv_pallas``
(turbo_metrics_tpu/ops/pallas/scale_stats.py:1985).

``fused_scale_rgb`` (kernel #3) is one level from a linear-RGB pair buffer
with the next level emitted (``tm_rgb_to_xyb`` + ``tm_level_sums``, twin
``fused_scale_rgb_ref``): scale 0 of the multi-metric path, replacing
``fused_scale_pallas_v4`` (turbo_metrics_tpu/ops/pallas/scale_stats.py:2552).

The level helpers (``level_sums_ref``, ``norms_from_sums``) are shared with
kernel 2.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check
from turbo_metrics_tpu_torch.ops.ssim_maps import edge_maps, ssim_map
from turbo_metrics_tpu_torch.ops.xyb import linear_rgb_to_xyb

TRANSFER_CODES = {"bt709": 0, "srgb": 1, "pq": 2, "hlg": 3, "linear": 4}


def norms_from_sums(sums: torch.Tensor, npx: int) -> torch.Tensor:
    """(..., 3, 6) sums -> (..., 3, 2, 3) norms matching ``scale_norms``."""
    inv = 1.0 / npx
    n1 = sums[..., 0::2] * inv  # d, art, det 1-norms
    n4 = torch.sqrt(torch.sqrt(sums[..., 1::2] * inv))
    return torch.stack([n1, n4], dim=-2)


def level_sums_ref(x1: torch.Tensor, x2: torch.Tensor, taps) -> torch.Tensor:
    """Plain per-level sums from XYB planes (B, 3, h, w) -> (B, 3, 6) f32.

    Blurs the 4 quantities the maps need (x1, x2, (x1-x2)^2, x1*x2: see
    ``ssim_map``), builds the maps and sums (d, d^4, art, art^4, det, det^4)
    in f64, like the kernel's final reduction.
    """
    diff = x1 - x2
    mu1, mu2, sdd, s12 = blur_2d(
        torch.stack([x1, x2, diff * diff, x1 * x2]), taps=taps
    ).unbind(0)
    d = ssim_map(mu1, mu2, sdd, s12)
    art, det = edge_maps(x1, x2, mu1, mu2)
    quantities = []
    for m in (d, art, det):
        m2 = m * m
        quantities += [m, m2 * m2]
    return torch.stack(
        [q.double().sum(dim=(-2, -1)) for q in quantities], dim=-1
    ).float()


def check_level_consts(taps: torch.Tensor, opsin: torch.Tensor, device) -> None:
    for name, t in (("taps", taps), ("opsin", opsin)):
        if (
            t.shape != (11,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()
        ):
            raise ValueError(f"{name} must be a contiguous (11,) float32 tensor on {device}")


def check_yuv(
    y2: torch.Tensor, uv2: torch.Tensor, depth: int, transfer: str, *, pair: bool = True
) -> None:
    """Planes of a pair, (2, B, h, w) + (2, B, ch, cw, 2), or with ``pair``
    false of one image per frame, (B, h, w) + (B, ch, cw, 2)."""
    if pair and (y2.ndim != 4 or y2.shape[0] != 2):
        raise ValueError(f"y2 must be (2, B, h, w), got {tuple(y2.shape)}")
    if not pair and y2.ndim != 3:
        raise ValueError(f"y must be (B, h, w), got {tuple(y2.shape)}")
    h, w = y2.shape[-2], y2.shape[-1]
    want_uv = (*y2.shape[:-2], (h + 1) // 2, (w + 1) // 2, 2)
    if tuple(uv2.shape) != want_uv:
        raise ValueError(f"uv2 must be {want_uv} for 4:2:0, got {tuple(uv2.shape)}")
    want_dt = torch.uint8 if depth == 8 else torch.uint16
    if not 8 <= depth <= 16 or y2.dtype != want_dt or uv2.dtype != want_dt:
        raise ValueError(
            f"{depth}-bit planes must be {want_dt}, got {y2.dtype}/{uv2.dtype}"
        )
    if y2.device != uv2.device:
        raise ValueError("y2 and uv2 must be on one device")
    if not (y2.is_contiguous() and uv2.is_contiguous()):
        raise ValueError("y2 and uv2 must be contiguous")
    if transfer not in TRANSFER_CODES:
        raise ValueError(f"unknown transfer {transfer!r}")


def check_level(p12: torch.Tensor) -> None:
    if p12.ndim != 5 or p12.shape[0] != 2 or p12.shape[2] != 3:
        raise ValueError(f"p12 must be (2, B, 3, h, w), got {tuple(p12.shape)}")
    if p12.dtype != torch.float32 or not p12.is_contiguous():
        raise ValueError("p12 must be contiguous float32")


def s2_level_scratch(lib, bsz: int, h: int, w: int, dev):
    """XYB, row-blurred planes and block partials of an h x w level."""
    n = bsz * 3 * h * w
    return (
        torch.empty(2 * n, dtype=torch.float32, device=dev),
        torch.empty(4 * n, dtype=torch.float32, device=dev),
        torch.empty(bsz * 3 * lib.tm_level_blocks(h, w) * 6, dtype=torch.float32, device=dev),
    )


def fused_scale0_yuv_ref(
    y2, uv2, taps, opsin, *, depth=8, matrix="bt709", transfer="bt709",
    full_range=False, emit_ds=True, kr_kb=None,
):
    """Plain twin of ``fused_scale0_yuv`` (same arguments and results)."""
    lin = colorspace.yuv420_to_linear_rgb(
        y2, uv2, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, kr_kb=kr_kb,
    )  # (2, B, 3, h, w)
    xyb = linear_rgb_to_xyb(lin, opsin=opsin)
    sums = level_sums_ref(xyb[0], xyb[1], taps)
    return sums, (downscale_by_2(lin) if emit_ds else None)


def fused_scale0_yuv(
    y2: torch.Tensor,
    uv2: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    emit_ds: bool = True,
    kr_kb=None,
):
    """Scale 0 of the pyramid from YUV 4:2:0 — conversion fused.

    ``y2``: (2, B, h, w) luma (reference, distorted), uint8 at 8 bits else
    uint16; ``uv2``: (2, B, ceil(h/2), ceil(w/2), 2) chroma.  ``taps`` and
    ``opsin``: (11,) f32 constants on the same device (the ``Ssimulacra2``
    module's buffers).  Returns (sums (B, 3, 6) f32, level 1 as contiguous
    (2, B, 3, ceil(h/2), ceil(w/2)) f32 linear RGB, or None without
    ``emit_ds``).  Full-resolution linear RGB is never stored.
    """
    check_yuv(y2, uv2, depth, transfer)
    check_level_consts(taps, opsin, y2.device)
    if y2.device.type == "cpu":
        return fused_scale0_yuv_ref(
            y2, uv2, taps, opsin, depth=depth, matrix=matrix, transfer=transfer,
            full_range=full_range, emit_ds=emit_ds, kr_kb=kr_kb,
        )
    if y2.device.type != "cuda":
        raise ValueError(f"fused_scale0_yuv runs on cuda or cpu, not {y2.device}")
    lib = LIBRARY.get()
    _, bsz, h, w = y2.shape
    dev = y2.device
    rng = colorspace.sample_range(depth, full_range)
    coeffs = colorspace.conversion_coeffs(depth, matrix, full_range, kr_kb)
    xyb, tmp, parts = s2_level_scratch(lib, bsz, h, w, dev)
    ds = (
        torch.empty((2, bsz, 3, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=dev)
        if emit_ds else None
    )
    sums = torch.empty((bsz, 3, 6), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(
        lib.tm_yuv420_to_xyb(
            y2.data_ptr(), uv2.data_ptr(), int(depth > 8), bsz, h, w, *coeffs,
            float(rng.minimum), float(rng.neutral), TRANSFER_CODES[transfer],
            opsin.data_ptr(), xyb.data_ptr(), ds.data_ptr() if emit_ds else None,
            stream,
        ),
        "tm_yuv420_to_xyb",
    )
    check(
        lib.tm_level_sums(
            xyb.data_ptr(), bsz, h, w, taps.data_ptr(), tmp.data_ptr(),
            parts.data_ptr(), sums.data_ptr(), 18, stream,
        ),
        "tm_level_sums",
    )
    fused_scale0_yuv.launches += 1
    return sums, ds


fused_scale0_yuv.launches = 0


def fused_scale_rgb_ref(p12, taps, opsin, *, emit_ds=True):
    """Plain twin of ``fused_scale_rgb`` (same arguments and results)."""
    xyb = linear_rgb_to_xyb(p12, opsin=opsin)
    sums = level_sums_ref(xyb[0], xyb[1], taps)
    return sums, (downscale_by_2(p12) if emit_ds else None)


def launch_rgb_level(lib, p12, taps, opsin, scratch, sums, sums_bstride, nxt) -> None:
    """``tm_rgb_to_xyb`` + ``tm_level_sums`` on one level ``p12`` (2, B, 3,
    h, w): sums into ``sums[b * sums_bstride + ch * 6 + k]``, the next level
    into ``nxt`` unless it is None.  ``scratch``: ``s2_level_scratch`` of a
    level at least this large."""
    _, bsz, _, h, w = p12.shape
    xyb, tmp, parts = scratch
    stream = torch.cuda.current_stream(p12.device).cuda_stream
    check(
        lib.tm_rgb_to_xyb(
            p12.data_ptr(), bsz, h, w, opsin.data_ptr(), xyb.data_ptr(),
            nxt.data_ptr() if nxt is not None else None, stream,
        ),
        "tm_rgb_to_xyb",
    )
    check(
        lib.tm_level_sums(
            xyb.data_ptr(), bsz, h, w, taps.data_ptr(), tmp.data_ptr(),
            parts.data_ptr(), sums.data_ptr(), sums_bstride, stream,
        ),
        "tm_level_sums",
    )


def fused_scale_rgb(
    p12: torch.Tensor, taps: torch.Tensor, opsin: torch.Tensor, *, emit_ds: bool = True
):
    """One pyramid level from linear RGB, the next level emitted.

    ``p12``: contiguous (2, B, 3, h, w) f32 linear RGB (reference,
    distorted), e.g. the conversion kernel's pair buffer.  Returns (sums (B,
    3, 6) f32, the edge-replicated 2x2 mean as (2, B, 3, ceil(h/2),
    ceil(w/2)) f32, or None without ``emit_ds``).
    """
    check_level(p12)
    check_level_consts(taps, opsin, p12.device)
    if p12.device.type == "cpu":
        return fused_scale_rgb_ref(p12, taps, opsin, emit_ds=emit_ds)
    if p12.device.type != "cuda":
        raise ValueError(f"fused_scale_rgb runs on cuda or cpu, not {p12.device}")
    lib = LIBRARY.get()
    _, bsz, _, h, w = p12.shape
    dev = p12.device
    ds = (
        torch.empty((2, bsz, 3, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=dev)
        if emit_ds else None
    )
    sums = torch.empty((bsz, 3, 6), dtype=torch.float32, device=dev)
    launch_rgb_level(lib, p12, taps, opsin, s2_level_scratch(lib, bsz, h, w, dev), sums, 18, ds)
    fused_scale_rgb.launches += 1
    return sums, ds


fused_scale_rgb.launches = 0
