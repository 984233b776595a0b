"""SSIMULACRA2 per-scale error maps and norm reductions.

The modified-SSIM map and the edge-difference (artifact / detail-loss) maps
with their 1-norm and 4-norm reductions (reference:
ssimulacra2-cuda/examples/cpu.rs:581-683).  Two rewrites keep f32 stable:
  * the SSIM map is one quotient, (denom - num_m*num_s) / denom, which is
    exactly 0 for identical inputs;
  * the edge-difference ratio is (a - b) / (1 + b) instead of
    (1 + a) / (1 + b) - 1, avoiding the literal form's cancellation.
"""

from __future__ import annotations

import numpy as np
import torch

C2 = float(np.float32(0.0009))


def ssim_map(mu1, mu2, sdd, s12):
    """Modified SSIM map (cpu.rs:604-631) from four blurred quantities:
    x1, x2, (x1 - x2)^2 and x1*x2.

    With md = mu1 - mu2, num_s = 2 (s12 - mu1 mu2) + C2 and var_d = sdd - md^2
    (the local variance of x1 - x2), linearity of the blur gives exactly
        denom_s               = (s11 - mu1^2) + (s22 - mu2^2) + C2 = num_s + var_d
        denom_s - num_m num_s = var_d + md^2 num_s.
    The numerator is then built from the small difference x1 - x2 itself
    instead of the difference of two nearly equal variance estimates, which
    for close images at deep scales cancels away most f32 digits (the
    five-blur form of ``scale_norms`` is ~1e-3 of score from the f64 value
    there, this form ~1e-5).
    """
    md = mu1 - mu2
    num_s = 2.0 * (s12 - mu1 * mu2) + C2
    var_d = sdd - md * md
    return torch.clamp_min((var_d + md * md * num_s) / (num_s + var_d), 0.0)


def edge_maps(img1, img2, mu1, mu2):
    """(artifact, detail-loss) maps (cpu.rs:651-674), stable form."""
    a = torch.abs(img2 - mu2)
    b = torch.abs(img1 - mu1)
    d1 = (a - b) / (1.0 + b)
    return torch.clamp_min(d1, 0.0), torch.clamp_min(-d1, 0.0)


def plain_maps(img1, img2, mu1, mu2, s11, s22, s12) -> tuple:
    """The plain chain's (ssim, artifact, detail-loss) maps from its five
    blurs: the SSIM map as cpu.rs:604-631 writes it, from mu1, mu2 and the
    blurred products s11, s22, s12, and ``edge_maps``."""
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + C2
    denom_s = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + C2
    d = torch.clamp_min((denom_s - num_m * num_s) / denom_s, 0.0)
    return (d, *edge_maps(img1, img2, mu1, mu2))


def scale_norms(
    img1: torch.Tensor,
    img2: torch.Tensor,
    mu1: torch.Tensor,
    mu2: torch.Tensor,
    s11: torch.Tensor,
    s22: torch.Tensor,
    s12: torch.Tensor,
) -> torch.Tensor:
    """Per-scale reductions over (..., C, H, W) inputs.

    ``img1``/``img2`` are the XYB planes, ``mu*`` their blurs, ``s11``/``s22``/
    ``s12`` the blurred products blur(img1*img1) etc.

    Returns (..., C, 2, 3): axis -2 is the norm (0 = 1-norm, 1 = 4-norm),
    axis -1 is the map (0 = ssim, 1 = artifact, 2 = detail-loss) — the flat
    weight order of the final score (examples/cpu.rs:843-854).
    """
    def norms(m):
        n1 = torch.mean(m, dim=(-2, -1))
        m2 = m * m
        n4 = torch.sqrt(torch.sqrt(torch.mean(m2 * m2, dim=(-2, -1))))
        return torch.stack([n1, n4], dim=-1)  # (..., C, 2)

    return torch.stack([norms(m) for m in plain_maps(img1, img2, mu1, mu2, s11, s22, s12)], dim=-1)
