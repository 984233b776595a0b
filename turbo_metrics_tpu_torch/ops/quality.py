"""Classic quality metrics: PSNR, SSIM, MS-SSIM on 8-bit-quantized RGB.

Counterpart of the JAX package's ops/quality.py (itself standing in for the
NPP primitives the reference calls, turbo-metrics/src/lib.rs:296-339).  Like
the reference, these operate on linear-RGB frames quantized to 8 bits;
inputs of ``psnr``/``ssim``/``msssim``/``ssim_msssim`` are f32 tensors
holding code values in [0, 255], layout (..., 3, H, W).  SSIM is Wang et al.
2004 with an 11x11 sigma=1.5 Gaussian window on the valid region; MS-SSIM
Wang et al. 2003 with the standard five scale weights.

Two routes, as for SSIMULACRA2:
  * the plain functions here (``_ssim_parts`` and what builds on it), the
    counterpart of the JAX jnp path and the twins the kernels are held
    against;
  * ``quality_from_rgb``: the multi-metric path on the converted linear-RGB
    pair buffer, through ops/kernels/windowed.py (level 0, quantized at
    load) and ops/kernels/windowed_tail.py (MS-SSIM levels 1-4), which run
    their CUDA kernels on CUDA tensors and these plain functions on CPU
    tensors.  PSNR stays a plain torch expression, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from turbo_metrics_tpu_torch.models.ssimulacra2 import resolve_device
from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
from turbo_metrics_tpu_torch.ops.gaussian import gaussian_window

RADIUS = 5  # gaussian_window(11, 1.5)
C1 = float(np.float32((0.01 * 255.0) ** 2))
C2 = float(np.float32((0.03 * 255.0) ** 2))

MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], dtype=np.float64)


def psnr(a: torch.Tensor, b: torch.Tensor, *, peak: float = 255.0) -> torch.Tensor:
    """PSNR in dB over all channels, f32; (..., C, H, W) -> (...,).  An
    identical pair gives inf."""
    diff = a - b
    mse = torch.mean(diff * diff, dim=(-3, -2, -1))
    return 10.0 * torch.log10(float(np.float32(peak * peak)) / mse)


def _window_list(win) -> list[float]:
    """The window taps as f32-exact Python floats (default: the 11-tap
    sigma=1.5 window)."""
    if win is None:
        win = gaussian_window(11, 1.5)
    if isinstance(win, torch.Tensor):
        win = win.detach().cpu().numpy()
    return [float(v) for v in np.asarray(win).astype(np.float32)]


def _filter_valid(x: torch.Tensor, win) -> torch.Tensor:
    """Separable 'valid' correlation with a 1D window over the last two axes,
    a sum of shifted products in tap order (the JAX package's order)."""
    w = _window_list(win)
    n = len(w)
    wdim = x.shape[-1] - n + 1
    x = sum(w[k] * x[..., k : k + wdim] for k in range(n))
    hdim = x.shape[-2] - n + 1
    return sum(w[k] * x[..., k : k + hdim, :] for k in range(n))


def _ssim_parts(a, b, win=None, c1: float = C1, c2: float = C2):
    """Per-pixel (luminance, cs) maps over the valid grid, five blurs (the
    jnp formulation)."""
    mu1 = _filter_valid(a, win)
    mu2 = _filter_valid(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11 = _filter_valid(a * a, win) - mu1_sq
    s22 = _filter_valid(b * b, win) - mu2_sq
    s12 = _filter_valid(a * b, win) - mu12
    luminance = (2.0 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2.0 * s12 + c2) / (s11 + s22 + c2)
    return luminance, cs


def _level_means(a, b):
    luminance, cs = _ssim_parts(a, b)
    return (
        torch.mean(luminance * cs, dim=(-3, -2, -1)),
        torch.mean(cs, dim=(-3, -2, -1)),
    )


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM index; (..., C, H, W) -> (...,)."""
    return _level_means(a, b)[0]


def _downsample_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2, truncating odd edges (MS-SSIM step)."""
    h, w = x.shape[-2] & ~1, x.shape[-1] & ~1
    x = x[..., :h, :w]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(dim=(-3, -1))


def _clamp_levels(h: int, w: int, levels: int, weights=MSSSIM_WEIGHTS):
    """Clamp MS-SSIM levels so the 11x11 window still fits after
    downsampling (min dim >= 11 * 2^(levels-1)); renormalise the clamped
    weights to sum 1."""
    fit = max(1, (min(h, w) // 11).bit_length())
    levels = min(levels, fit)
    w_ = np.asarray(weights, dtype=np.float64)[:levels]
    if levels < len(weights):
        w_ = w_ / w_.sum()
    return levels, w_


def _msssim_levels(a, b, levels: int):
    """Per-level (mean(luminance*cs), mean(cs)) plus the clamped weights.
    Level 0's first mean IS the single-scale SSIM index."""
    levels, weights = _clamp_levels(a.shape[-2], a.shape[-1], levels)
    per_level = []
    for lvl in range(levels):
        per_level.append(_level_means(a, b))
        if lvl < levels - 1:
            a = _downsample_2x2(a)
            b = _downsample_2x2(b)
    return per_level, weights


def _msssim_combine(per_level, weights) -> torch.Tensor:
    levels = len(per_level)
    result = None
    for lvl, (ml, mcs) in enumerate(per_level):
        base = ml if lvl == levels - 1 else mcs
        term = torch.pow(torch.clamp_min(base, 0.0), float(np.float32(weights[lvl])))
        result = term if result is None else result * term
    return result


def msssim(a: torch.Tensor, b: torch.Tensor, *, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang 2003); (..., C, H, W) -> (...,)."""
    return _msssim_combine(*_msssim_levels(a, b, levels))


def ssim_msssim(a, b, *, levels: int = 5):
    """(SSIM, MS-SSIM) sharing one level-0 pass: MS-SSIM's level 0 computes
    exactly the statistics SSIM needs."""
    per_level, weights = _msssim_levels(a, b, levels)
    return per_level[0][0], _msssim_combine(per_level, weights)


def means_from_sums(sums: torch.Tensor, h: int, w: int):
    """(B, 3, 2) per-channel sums of one h x w level -> (mean(luminance*cs),
    mean(cs)) over channels and the valid grid, each (B,)."""
    count = float(3 * (h - 2 * RADIUS) * (w - 2 * RADIUS))
    return sums[:, :, 0].sum(dim=-1) / count, sums[:, :, 1].sum(dim=-1) / count


def builtin_constants() -> dict:
    """The constants of the SSIM family as numpy arrays: the 11 window taps
    (f64), the stabilisers C1 and C2 (f32) and the five MS-SSIM weights."""
    return {
        "ssim_window": gaussian_window(11, 1.5),
        "c1": np.float32(C1),
        "c2": np.float32(C2),
        "msssim_weights": MSSSIM_WEIGHTS.copy(),
    }


def quality_from_rgb(
    p12: torch.Tensor,
    window: torch.Tensor,
    *,
    want_psnr: bool = False,
    want_ssim: bool = False,
    want_msssim: bool = False,
    levels: int = 5,
    c1: float = C1,
    c2: float = C2,
    weights=MSSSIM_WEIGHTS,
) -> dict:
    """PSNR/SSIM/MS-SSIM straight from a (2, B, 3, h, w) linear-RGB pair
    buffer (the conversion kernel's output), each (B,) f32.

    The 8-bit quantization (clip(round(lin*255)), the reference's
    f32_to_8bit before NPP) happens at load inside the level-0 SSIM kernel;
    SSIM and MS-SSIM share that level.  ``window``: the (11,) f32 taps on
    ``p12``'s device.
    """
    # Imported here: the kernel modules import this one for their twins.
    from turbo_metrics_tpu_torch.ops.kernels.windowed import ssim_sums
    from turbo_metrics_tpu_torch.ops.kernels.windowed_tail import msssim_tail

    h, w = p12.shape[-2], p12.shape[-1]
    out = {}
    if want_psnr:
        q = f32_to_uint8(p12, torch.float32)
        out["psnr"] = psnr(q[0], q[1])
    if want_msssim:
        lv, wts = _clamp_levels(h, w, levels, weights)
        sums0, ds = ssim_sums(p12, window, quantize=True, emit_ds=lv > 1, c1=c1, c2=c2)
        per_level = [means_from_sums(sums0, h, w)]
        if lv > 1:
            tail = msssim_tail(ds, lv - 1, window, c1=c1, c2=c2)
            lh, lw = h // 2, w // 2
            for li in range(lv - 1):
                per_level.append(means_from_sums(tail[:, li], lh, lw))
                lh, lw = lh // 2, lw // 2
        out["msssim"] = _msssim_combine(per_level, wts)
        if want_ssim:
            out["ssim"] = per_level[0][0]
    elif want_ssim:
        sums0, _ = ssim_sums(p12, window, quantize=True, emit_ds=False, c1=c1, c2=c2)
        out["ssim"] = means_from_sums(sums0, h, w)[0]
    return out


class Quality(nn.Module):
    """PSNR/SSIM/MS-SSIM on an explicit device.

    Buffer ``window`` holds the SSIM window taps as f32 on the device, where
    the kernels read them; ``c1``, ``c2`` (floats) and ``msssim_weights``
    (f64) stay on the host.  ``constants_from_numpy`` installs replacements.
    """

    def __init__(self, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.register_buffer("window", torch.empty(11, dtype=torch.float32, device=dev))
        self.constants_from_numpy(builtin_constants())

    def constants_from_numpy(self, d: dict) -> None:
        """Install constants given as numpy arrays (``builtin_constants``
        keys), e.g. the JAX package's, into the module."""
        win = np.asarray(d["ssim_window"], dtype=np.float64).astype(np.float32)
        with torch.no_grad():
            self.window.copy_(torch.from_numpy(win))
        self.c1 = float(np.float32(d["c1"]))
        self.c2 = float(np.float32(d["c2"]))
        self.msssim_weights = np.asarray(d["msssim_weights"], dtype=np.float64).copy()

    @torch.no_grad()
    def from_rgb(self, p12: torch.Tensor, *, psnr=False, ssim=False, msssim=False) -> dict:
        return quality_from_rgb(
            p12, self.window, want_psnr=psnr, want_ssim=ssim, want_msssim=msssim,
            c1=self.c1, c2=self.c2, weights=self.msssim_weights,
        )
