"""Linear RGB -> positive-shifted XYB, the perceptual colorspace of SSIMULACRA2.

Math follows the canonical implementation (reference:
ssimulacra2-cuda/examples/cpu.rs:421-469): the JPEG XL opsin absorbance
matrix with bias, cube root, opponent recombination, then the affine shift
that brings every component into roughly [0, 1]:

    X' = 14 * X + 0.42,  Y' = Y + 0.01,  B' = (B - Y) + 0.55

All per-pixel math is f32, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

# Opsin constants; derived rows sum to 1 in f32 (cpu.rs:421-436).
_K_M02 = np.float32(0.078)
_K_M00 = np.float32(0.30)
_K_M01 = np.float32(1.0) - _K_M02 - _K_M00
_K_M12 = np.float32(0.078)
_K_M10 = np.float32(0.23)
_K_M11 = np.float32(1.0) - _K_M12 - _K_M10
_K_M20 = np.float32(0.24342269)
_K_M21 = np.float32(0.20476745)
_K_M22 = np.float32(1.0) - _K_M20 - _K_M21

OPSIN_ABSORBANCE_MATRIX = np.array(
    [
        [_K_M00, _K_M01, _K_M02],
        [_K_M10, _K_M11, _K_M12],
        [_K_M20, _K_M21, _K_M22],
    ],
    dtype=np.float32,
)
OPSIN_ABSORBANCE_BIAS = np.float32(0.0037930734)
OPSIN_ABSORBANCE_BIAS_ROOT = np.float32(0.15595420255272392)


def opsin_vector(
    matrix=OPSIN_ABSORBANCE_MATRIX,
    bias=OPSIN_ABSORBANCE_BIAS,
    bias_root=OPSIN_ABSORBANCE_BIAS_ROOT,
) -> np.ndarray:
    """The 9 matrix entries (row-major), the bias and the bias root as one
    (11,) f32 array: the layout the CUDA kernels read."""
    return np.concatenate(
        [np.asarray(matrix, dtype=np.float32).reshape(9), np.float32([bias, bias_root])]
    )


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    """Newton-refined cube root of max(v, 0) (the JAX package's ``_cbrt``).

    The seed is pow(v, 1/3); one Newton step brings it to ~1 ulp.  Inputs
    are >= the opsin bias > 0, but v == 0 is guarded anyway.
    """
    v = torch.clamp_min(v, 0.0)
    y0 = torch.pow(v, float(np.float32(1.0 / 3.0)))
    y0sq = y0 * y0
    refined = (2.0 * y0 + v / torch.clamp_min(y0sq, 1e-30)) * float(np.float32(1.0 / 3.0))
    return torch.where(v > 0.0, refined, torch.zeros_like(refined))


def linear_rgb_to_xyb(rgb: torch.Tensor, *, opsin=None, channel_axis: int = -3) -> torch.Tensor:
    """Convert linear RGB to positive-shifted XYB, same layout.

    ``rgb``: f32 with a 3-channel axis ``channel_axis`` (default layout
    (..., 3, H, W)); the result has channels (X', Y', B') there.
    ``opsin``: optional (11,) matrix/bias/root vector (``opsin_vector()``
    layout); defaults to the built-in constants.
    """
    if opsin is None:
        opsin = opsin_vector()
    if isinstance(opsin, torch.Tensor):
        opsin = opsin.detach().cpu().numpy()
    o = [float(v) for v in np.asarray(opsin, dtype=np.float32)]
    m = [o[0:3], o[3:6], o[6:9]]
    bias, root = o[9], o[10]
    r, g, b = rgb.unbind(dim=channel_axis)
    rmix = m[0][0] * r + m[0][1] * g + m[0][2] * b + bias
    gmix = m[1][0] * r + m[1][1] * g + m[1][2] * b + bias
    bmix = m[2][0] * r + m[2][1] * g + m[2][2] * b + bias

    rg = _cbrt(rmix) - root
    gr = _cbrt(gmix) - root
    bb = _cbrt(bmix) - root

    x = 0.5 * (rg - gr)
    y = 0.5 * (rg + gr)
    # Positive shift folded in, exactly as cpu.rs:468 (B' uses unshifted Y).
    out = [x * 14.0 + float(np.float32(0.42)), y + float(np.float32(0.01)),
           bb - y + float(np.float32(0.55))]
    return torch.stack(out, dim=channel_axis)
