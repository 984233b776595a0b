"""Planar Y'CbCr and gamma sRGB to linear RGB.

The conventions of turbo-metrics' colour kernels (cuda-colorspace-kernel):
the Y'CbCr matrix derived from the colour primaries through XYZ, luma
clamped below at the range's minimum, nearest-neighbour chroma (one chroma
sample per 2x2 luma block at 4:2:0, per 1x2 at 4:2:2), the BT.709 transfer
as the inverse of its OETF, the sRGB transfer as its piecewise EOTF, and
linear RGB clamped to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

_D65 = (0.3127, 0.3290)
# ITU-R BT.709 / BT.2020 primaries (x, y) of R, G, B and the white point.
PRIMARIES = {
    "bt709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _D65),
}


def luma_weights(matrix: str) -> tuple[float, float]:
    """(kr, kb) of a Y'CbCr matrix, from its primaries through XYZ."""
    def xyz(x, y):
        return np.array([x / y, 1.0, (1.0 - x - y) / y])

    r, g, b, w = (xyz(*p) for p in PRIMARIES[matrix])
    m = np.stack([r, g, b], axis=1)  # columns: the primaries' XYZ
    kr = np.dot(w, np.cross(g, b)) / np.linalg.det(m)
    kb = np.dot(w, np.cross(r, g)) / np.linalg.det(m)
    return float(kr), float(kb)


def code_range(depth: int, full_range: bool) -> tuple[int, int, int, int]:
    """(minimum, luma maximum, chroma maximum, neutral chroma) of the codes."""
    if full_range:
        top = (1 << depth) - 1
        return 0, top, top, 1 << (depth - 1)
    s = depth - 8
    return 16 << s, 235 << s, 240 << s, 1 << (depth - 1)


def bt709_eotf(v: torch.Tensor) -> torch.Tensor:
    """Inverse of the BT.709 OETF, 1.099 v^0.45 - 0.099 above 4.5 * 0.018."""
    beta = 0.018053968510807
    alpha = 1.0 + 5.5 * beta
    hi = torch.clamp_min((v + (alpha - 1.0)) / alpha, 0.0) ** (1.0 / 0.45)
    return torch.where(v >= 4.5 * beta, hi, v / 4.5)


def srgb_eotf(v: torch.Tensor) -> torch.Tensor:
    """The sRGB EOTF with the constants of turbo-metrics' srgb.rs."""
    alpha, beta = 1.0550107, 0.0030412825
    hi = torch.clamp_min((v + (alpha - 1.0)) / alpha, 0.0) ** 2.4
    return torch.where(v < 12.92 * beta, v / 12.92, hi)


EOTF = {"bt709": bt709_eotf, "srgb": srgb_eotf}


def yuv_to_linear_rgb(y: torch.Tensor, uv: torch.Tensor, *, depth: int, chroma: int, matrix: str, transfer: str,
                      full_range: bool, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W) luma and (B, ch, cw, 2) chroma codes -> (B, 3, H, W) linear
    RGB in ``dtype``."""
    kr, kb = luma_weights(matrix)
    kg = 1.0 - kr - kb
    lo, luma_max, chroma_max, neutral = code_range(depth, full_range)
    h, w = y.shape[-2:]
    yl = (torch.clamp_min(y.to(dtype), lo) - lo) / (luma_max - lo)
    cb = (uv[..., 0].to(dtype) - neutral) / (chroma_max - lo)
    cr = (uv[..., 1].to(dtype) - neutral) / (chroma_max - lo)

    def up(c):
        if chroma != 444:
            c = c.repeat_interleave(2, dim=-1)
        if chroma == 420:
            c = c.repeat_interleave(2, dim=-2)
        return c[..., :h, :w]

    r = yl + up(2.0 * (1.0 - kr) * cr)
    g = yl + up(-2.0 * (1.0 - kb) * kb / kg * cb - 2.0 * (1.0 - kr) * kr / kg * cr)
    b = yl + up(2.0 * (1.0 - kb) * cb)
    return torch.clamp(EOTF[transfer](torch.stack([r, g, b], dim=-3)), 0.0, 1.0)


def srgb_to_linear(rgb: torch.Tensor, *, depth: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) gamma sRGB codes -> (B, 3, H, W) linear RGB in ``dtype``."""
    v = rgb.permute(0, 3, 1, 2).to(dtype) / ((1 << depth) - 1)
    return torch.clamp(srgb_eotf(v), 0.0, 1.0)
