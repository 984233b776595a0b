"""PSNR, SSIM and MS-SSIM of 8-bit code values, as turbo-metrics scores them:
linear RGB quantized to 8 bits (clip(round(x * 255)), rounding half to
even), all three channels together.

SSIM is Wang et al. (2004): an 11 x 11 Gaussian window of sigma 1.5 over
the valid region, K1 0.01, K2 0.03, L 255, the mean over channels and
positions.  MS-SSIM is Wang et al. (2003): five scales with the weights
0.0448, 0.2856, 0.3001, 0.2363, 0.1333, fewer (the weights renormalised)
where the window would not fit, each scale the 2x2 mean of the last with
its odd edge dropped, the contrast-structure means at every scale but the
last and the SSIM mean at the last.
"""

from __future__ import annotations

import math

import numpy as np
import torch

C1 = (0.01 * 255.0) ** 2
C2 = (0.03 * 255.0) ** 2
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _window() -> list[float]:
    g = [math.exp(-((i - 5.0) ** 2) / (2.0 * 1.5 ** 2)) for i in range(11)]
    return [v / sum(g) for v in g]


WINDOW = _window()


def quantize(lin: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(lin * 255.0), 0.0, 255.0)


def psnr(q_ref: torch.Tensor, q_dis: torch.Tensor) -> np.ndarray:
    """(B, 3, h, w) codes -> (B,) dB."""
    d = (q_ref - q_dis).to(torch.float64)
    mse = (d * d).mean(dim=(-3, -2, -1)).cpu().numpy()
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _valid(x: torch.Tensor) -> torch.Tensor:
    w = x.shape[-1] - 10
    x = sum(t * x[..., k:k + w] for k, t in enumerate(WINDOW))
    h = x.shape[-2] - 10
    return sum(t * x[..., k:k + h, :] for k, t in enumerate(WINDOW))


def _means(a: torch.Tensor, b: torch.Tensor, sum_dtype: torch.dtype):
    """(mean SSIM, mean contrast-structure) of (B, 3, h, w) codes."""
    mu1, mu2 = _valid(a), _valid(b)
    s11 = _valid(a * a) - mu1 * mu1
    s22 = _valid(b * b) - mu2 * mu2
    s12 = _valid(a * b) - mu1 * mu2
    lum = (2.0 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)
    cs = (2.0 * s12 + C2) / (s11 + s22 + C2)
    ssim = (lum * cs).to(sum_dtype).mean(dim=(-3, -2, -1))
    return ssim.double().cpu().numpy(), cs.to(sum_dtype).mean(dim=(-3, -2, -1)).double().cpu().numpy()


def _down(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2] & ~1, x.shape[-1] & ~1
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 1::2]) / 4


def ssim_msssim(q_ref: torch.Tensor, q_dis: torch.Tensor, sum_dtype: torch.dtype) -> tuple[np.ndarray, np.ndarray]:
    """(B, 3, h, w) codes -> ((B,) SSIM, (B,) MS-SSIM)."""
    levels = min(5, max(1, (min(q_ref.shape[-2:]) // 11).bit_length()))
    weights = np.array(MSSSIM_WEIGHTS[:levels])
    if levels < len(MSSSIM_WEIGHTS):
        weights = weights / weights.sum()
    a, b = q_ref, q_dis
    result = 1.0
    ssim = None
    for level in range(levels):
        mean_ssim, mean_cs = _means(a, b, sum_dtype)
        if level == 0:
            ssim = mean_ssim
        base = mean_ssim if level == levels - 1 else mean_cs
        result = result * np.maximum(base, 0.0) ** weights[level]
        if level < levels - 1:
            a, b = _down(a), _down(b)
    return ssim, result
