"""SSIMULACRA 2.1 from linear RGB (Cloudinary's definition, as the
turbo-metrics CPU reference ssimulacra2-cuda/examples/cpu.rs computes it).

Six scales at most (a scale is computed while the previous one is at least
8 x 8), each the 2x2 mean of the last with its odd edge replicated; per
scale the positive-shifted XYB of both images, the recursive Gaussian of
sigma 1.5 applied as the 11-tap filter that its recurrence equals (taps
worked out here from the published recurrence constants; zero outside the
image), the modified SSIM map and the artifact and detail-loss maps, their
1- and 4-norms; the 108 published weights and the output nonlinearity.
"""

from __future__ import annotations

import numpy as np
import torch

# Recurrence constants of the recursive Gaussian (cpu.rs), f32 literals.
_MUL_IN = np.float32([0.055295236, -0.058836687, 0.012955819]).astype(np.float64)
_MUL_PREV = np.float32([1.9021131, 1.1755705, 1.2246469e-16]).astype(np.float64)
RADIUS = 5
C2 = 0.0009

# The opsin absorbance matrix, bias and the XYB shift (cpu.rs), f32 literals.
_M02, _M00 = np.float32(0.078), np.float32(0.30)
_M12, _M10 = np.float32(0.078), np.float32(0.23)
_M20, _M21 = np.float32(0.24342269), np.float32(0.20476745)
OPSIN = np.array([
    [_M00, np.float32(1.0) - _M02 - _M00, _M02],
    [_M10, np.float32(1.0) - _M12 - _M10, _M12],
    [_M20, _M21, np.float32(1.0) - _M20 - _M21],
], dtype=np.float32).astype(np.float64)
BIAS = float(np.float32(0.0037930734))

# fmt: off
WEIGHTS = np.array([
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346, 0.00066284834129271,
    0.00015231632783718752, 0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0, 0.0007989109436015163,
    0.000176816438078653, 0.0, 1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0, 0.00014003424285435884,
    0.9981766977854967, 0.00031949755934435053, 0.0004550992113792063, 0.0,
    0.0, 0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016, 0.0011401524586618361,
    0.001237755635509985, 176.39317598450694, 0.0, 0.0, 24.43300999870476,
    0.28520802612117757, 0.0004485436923833408, 0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862, 23.19243343998926,
    0.0, 95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379, 0.0, 0.0,
    0.0, 0.0005130064588990679, 0.0, 0.00010854057858411537,
])
# fmt: on


def blur_taps() -> np.ndarray:
    """The 11 taps of the recursive Gaussian: its response to a unit
    impulse, run in float64 (the oscillators cancel outside radius 5)."""
    n = 512
    x = np.zeros(n)
    x[n // 2] = 1.0
    out = np.zeros(n)
    prev = np.zeros(3)
    prev2 = np.zeros(3)
    for i in range(-RADIUS + 1, n):
        left, right = i - RADIUS - 1, i + RADIUS - 1
        s = (x[left] if left >= 0 else 0.0) + (x[right] if 0 <= right < n else 0.0)
        cur = s * _MUL_IN + _MUL_PREV * prev - prev2
        prev2, prev = prev, cur
        if i >= 0:
            out[i] = cur.sum()
    return out[n // 2 - RADIUS:n // 2 + RADIUS + 1]


TAPS = [float(t) for t in blur_taps()]


def scale_dims(h: int, w: int) -> list[tuple[int, int]]:
    """The (h, w) of each computed scale."""
    dims = []
    for s in range(6):
        if h < 8 or w < 8:
            break
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        dims.append((h, w))
    return dims


def _blur(x: torch.Tensor) -> torch.Tensor:
    """The 11-tap filter along the width, then the height, zero outside."""
    h, w = x.shape[-2:]
    p = torch.nn.functional.pad(x, (RADIUS, RADIUS))
    x = sum(t * p[..., k:k + w] for k, t in enumerate(TAPS))
    p = torch.nn.functional.pad(x, (0, 0, RADIUS, RADIUS))
    return sum(t * p[..., k:k + h, :] for k, t in enumerate(TAPS))


def _half(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, the odd last row or column replicated."""
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if x.shape[-1] % 2:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2] + x[..., 1::2, 1::2]) / 4


def _xyb(rgb: torch.Tensor) -> torch.Tensor:
    """(B, 3, h, w) linear RGB -> positive-shifted XYB."""
    root = BIAS ** (1.0 / 3.0)
    mixed = [sum(float(OPSIN[i, j]) * rgb[:, j] for j in range(3)) + BIAS for i in range(3)]
    r, g, b = (torch.clamp_min(m, 0.0) ** (1.0 / 3.0) - root for m in mixed)
    x, y = 0.5 * (r - g), 0.5 * (r + g)
    return torch.stack([14.0 * x + 0.42, y + 0.01, b - y + 0.55], dim=1)


def subscores(lin_ref: torch.Tensor, lin_dis: torch.Tensor, sum_dtype: torch.dtype) -> np.ndarray:
    """(B, 3, h, w) linear-RGB pairs -> (B, 3, S, 2, 3) float64 sub-scores:
    channel, scale, norm (1, 4), map (ssim, artifact, detail loss)."""
    per_scale = []
    a, b = lin_ref, lin_dis
    for s, _ in enumerate(scale_dims(*a.shape[-2:])):
        if s:
            a, b = _half(a), _half(b)
        x1, x2 = _xyb(a), _xyb(b)
        mu1, mu2 = _blur(x1), _blur(x2)
        s11, s22, s12 = _blur(x1 * x1), _blur(x2 * x2), _blur(x1 * x2)
        num = (1.0 - (mu1 - mu2) ** 2) * (2.0 * (s12 - mu1 * mu2) + C2)
        den = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + C2
        ssim = torch.clamp_min(1.0 - num / den, 0.0)
        d1 = (1.0 + (x2 - mu2).abs()) / (1.0 + (x1 - mu1).abs()) - 1.0
        maps = (ssim, torch.clamp_min(d1, 0.0), torch.clamp_min(-d1, 0.0))
        norms = []
        for m in maps:
            m = m.to(sum_dtype)
            n1 = m.mean(dim=(-2, -1))
            n4 = (m ** 4).mean(dim=(-2, -1)) ** 0.25
            norms.append(torch.stack([n1, n4], dim=-1))  # (B, 3, 2)
        per_scale.append(torch.stack(norms, dim=-1))  # (B, 3, 2, 3)
    return torch.stack(per_scale, dim=2).double().cpu().numpy()


def score(sub: np.ndarray) -> np.ndarray:
    """(B, 3, S, 2, 3) sub-scores -> (B,) scores, in float64."""
    s = sub.shape[2]
    w = WEIGHTS[:3 * s * 6].reshape(3, s, 2, 3)
    x = np.einsum("bcsnm,csnm->b", np.abs(sub), w) * 0.9562382616834844
    x = 6.248496625763138e-5 * x ** 3 + 2.326765642916932 * x - 0.020884521182843837 * x ** 2
    return np.where(x > 0.0, 100.0 - 10.0 * np.maximum(x, 0.0) ** 0.6276336467831387, 100.0)
