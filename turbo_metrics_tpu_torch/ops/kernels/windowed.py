"""Kernel #11: one SSIM level's windowed sums, with the next MS-SSIM level.

``ssim_sums`` launches ``tm_ssim_level`` (csrc/windowed.cu) on a CUDA tensor
and runs its plain twin ``ssim_sums_ref`` on a CPU tensor.  It replaces the
JAX package's ``ssim_sums_pallas`` (turbo_metrics_tpu/ops/pallas/windowed.py:
400) as ``ssim_level_padded`` (l.547) and ``msssim_level_means_padded``
(l.582) call it: per channel the sums of luminance*cs and of cs over the
valid grid, optionally quantizing the level to 8-bit code values at load,
optionally emitting the truncating 2x2 mean (the semantics of
``_emit_halfpool_tiles``, l.94) as the next MS-SSIM level.

``columns=(lo, hi)``: the level's owned columns (None: the whole width).
A column strip of a frame cut with a halo (parallel/mesh.py
``spatial_sharding``) correlates and emits every column it holds but sums
only the valid outputs centred on its own columns (``valid_window``); a
strip's level narrower than the window owns no valid output and adds
zeros without a launch.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import quality
from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W, check_level

WINDOW = 2 * quality.RADIUS + 1


def check_ssim_level(q12: torch.Tensor, window: torch.Tensor, windowed: bool = False) -> None:
    """The level's layout and the taps; a level at least 11x11, or with
    ``windowed`` (a strip's level) at least 11 rows."""
    check_level(q12)
    if (q12.shape[-2] if windowed else min(q12.shape[-2], q12.shape[-1])) < WINDOW:
        raise ValueError(f"an SSIM level must be at least {WINDOW}x{WINDOW}, got {tuple(q12.shape)}")
    if (
        window.shape != (WINDOW,) or window.dtype != torch.float32
        or window.device != q12.device or not window.is_contiguous()
    ):
        raise ValueError(f"window must be a contiguous ({WINDOW},) float32 tensor on {q12.device}")


def valid_window(columns, w: int) -> tuple[int, int]:
    """The valid grid's columns [clo, chi) whose outputs are centred on the
    owned columns ``columns`` = (lo, hi) of a w wide level (output j on
    input column j + 5), clipped to the grid; (0, w - 10) for None.
    ``ValueError`` unless 0 <= lo < hi <= w."""
    wv = w - WINDOW + 1
    if columns is None:
        return 0, wv
    lo, hi = (int(c) for c in columns)
    if not 0 <= lo < hi <= w:
        raise ValueError(f"columns must satisfy 0 <= lo < hi <= {w}, got {tuple(columns)}")
    clo = min(max(lo - quality.RADIUS, 0), max(wv, 0))
    return clo, min(max(hi - quality.RADIUS, clo), max(wv, 0))


def _owns_nothing(q12, columns, emit_ds):
    """(zero sums, None) for a strip's level narrower than the window, which
    owns no valid output; None for any other level.  Such a level's next
    levels are narrower still: ``ValueError`` where one is asked for."""
    if columns is None or q12.shape[-1] >= WINDOW:
        return None
    if emit_ds:
        raise ValueError(f"a level {q12.shape[-1]} columns wide has no valid output and emits no next level")
    return torch.zeros((q12.shape[1], 3, 2), dtype=torch.float32, device=q12.device), None


def ssim_sums_ref(q12, window, *, quantize=False, emit_ds=False, c1=quality.C1, c2=quality.C2, columns=None):
    """Plain twin of ``ssim_sums`` (same arguments and results): the jnp
    formulation (five blurs), sums in f64."""
    clo, chi = valid_window(columns, q12.shape[-1])
    empty = _owns_nothing(q12, columns, emit_ds)
    if empty is not None:
        return empty
    q = f32_to_uint8(q12, torch.float32) if quantize else q12
    lum, cs = quality._ssim_parts(q[0], q[1], window, c1, c2)
    if columns is not None:
        lum, cs = lum[..., clo:chi], cs[..., clo:chi]
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
    columns=None,
):
    """Per-channel (sum(luminance*cs), sum(cs)) of one SSIM level.

    ``q12``: contiguous (2, B, 3, h, w) f32 (reference, distorted), 8-bit
    code values, or with ``quantize`` linear RGB in [0, 1] quantized at load
    (clip(round(x*255), 0, 255), half to even).  ``window``: the (11,) f32
    taps on the same device.  Returns ((B, 3, 2) f32 sums over the (h-10) x
    (w-10) valid grid, or its outputs centred on the owned columns
    ``columns`` (module docstring), the next level (2, B, 3, h//2, w//2) f32
    of the (quantized) values with ``emit_ds``, else None).
    """
    check_ssim_level(q12, window, columns is not None)
    clo, chi = valid_window(columns, q12.shape[-1])
    if q12.device.type == "cpu":
        return ssim_sums_ref(q12, window, quantize=quantize, emit_ds=emit_ds, c1=c1, c2=c2, columns=columns)
    if q12.device.type != "cuda":
        raise ValueError(f"ssim_sums runs on cuda or cpu, not {q12.device}")
    empty = _owns_nothing(q12, columns, emit_ds)
    if empty is not None:
        return empty
    lib = LIBRARY.get()
    _, bsz, _, h, w = q12.shape
    dev = q12.device
    sums = torch.empty((bsz, 3, 2), dtype=torch.float32, device=dev)
    ds = (
        torch.empty((2, bsz, 3, h // 2, w // 2), dtype=torch.float32, device=dev)
        if emit_ds else None
    )
    launch_level(lib, q12, window, quantize, c1, c2, sums, 6, ds, (clo, chi))
    ssim_sums.launches += 1
    return sums, ds


ssim_sums.launches = 0


def launch_level(lib, q12, window, quantize, c1, c2, sums, sums_bstride, ds, valid, parts=None):
    """One ``tm_ssim_level`` call on the current stream, the valid grid's
    columns ``valid`` = (clo, chi) summed (``valid_window``).  ``parts``:
    the partials of a level at least this large (``level_scratch``;
    allocated here when None)."""
    _, bsz, _, h, w = q12.shape
    if parts is None:
        parts = level_scratch(bsz, h, w, q12.device)
    with launch_stream(q12.device) as stream:
        check(
            lib.tm_ssim_level(
                q12.data_ptr(), bsz, h, w, int(quantize), window.data_ptr(), float(c1), float(c2),
                int(valid[0]), int(valid[1]), parts.data_ptr(), sums.data_ptr(), sums_bstride,
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
