"""VIF (Visual Information Fidelity) elementary features, float pipeline.

The port's copy of the JAX package's ops/vif.py: the classic pixel-domain
VIF that VMAF uses, at 4 scales (vif_scale0..3).

  per scale k in 0..3:
    window: Gaussian, N = 2^(4-k) + 1 taps, sigma = N/5
    k > 0: ref/dis <- decimate2(blur_N(ref/dis))   [the CURRENT scale's
           window, as in the classic vifp_mscale.m and libvmaf's vif.c]
    mu1, mu2       = blur_N(ref), blur_N(dis)
    sigma1_sq      = blur_N(ref^2)  - mu1^2   (clamped >= 0)
    sigma2_sq      = blur_N(dis^2)  - mu2^2   (clamped >= 0)
    sigma12        = blur_N(ref*dis) - mu1*mu2
    g              = sigma12 / (sigma1_sq + eps), guarded
    sv_sq          = sigma2_sq - g * sigma12, guarded
    num           += log2(1 + g^2 * sigma1_sq / (sv_sq + sigma_nsq))
    den           += log2(1 + sigma1_sq / sigma_nsq)
    vif_scale_k    = num / den

with sigma_nsq = 2, eps = 1e-10, reflect-101 borders (libvmaf's
vif_filter1d mirroring: ind < 0 -> -ind, ind >= n -> 2n-ind-2, repeated
where a window is wider than the frame, as ``jnp.pad(mode="reflect")``
does).  Inputs are luma code values normalised to the 8-bit range.

These are the plain torch versions, in the JAX package's f32 expression
order; the CUDA kernels (ops/kernels/vif.py) compute the same sums.
``vif_scale_stats`` takes its JAX namesake's keywords and routes as it does
(ops/routes.py): #14 and #15 on a CUDA tensor behind JAX's gate, and with
``integer=True`` the fixed-point sums, K-int-VIF on a CUDA tensor
(ops/kernels/integer_vif.py) and ops/integer_vif.py elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import routes

SIGMA_NSQ = np.float32(2.0)
EPS = np.float32(1e-10)
NUM_SCALES = 4


def vif_window(scale: int) -> np.ndarray:
    """Gaussian window for a VIF scale: N = 2^(4-k)+1 taps, sigma = N/5 (f64)."""
    n = (1 << (4 - scale)) + 1
    sigma = n / 5.0
    half = (n - 1) / 2.0
    g = np.exp(-((np.arange(n) - half) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float64)


def reflect101_index(n: int, r: int, device=None) -> torch.Tensor:
    """Source indices of an axis of n padded by r on both sides, reflect-101
    (period 2(n-1), so pads wider than the axis keep reflecting)."""
    idx = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    p = 2 * (n - 1)
    m = idx.remainder(p)
    return torch.where(m < n, m, p - m)


def _taps(win: np.ndarray, device) -> list[torch.Tensor]:
    return [torch.tensor(np.float32(v), device=device) for v in win]


def blur_same(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable 'same' correlation with reflect-101 borders, rows first."""
    n = len(win)
    r = n // 2
    h, w = x.shape[-2], x.shape[-1]
    taps = _taps(win, x.device)
    xp = x.index_select(-1, reflect101_index(w, r, x.device))
    acc = taps[0] * xp[..., 0:w]
    for k in range(1, n):
        acc = acc + taps[k] * xp[..., k : k + w]
    xp = acc.index_select(-2, reflect101_index(h, r, x.device))
    acc = taps[0] * xp[..., 0:h, :]
    for k in range(1, n):
        acc = acc + taps[k] * xp[..., k : k + h, :]
    return acc


def decimate2(x: torch.Tensor) -> torch.Tensor:
    return x[..., ::2, ::2]


def window_columns(columns, w: int) -> tuple[int, int]:
    """The window [lo, hi) of a w wide scale's columns whose maps are summed:
    ``columns``, or (0, w) for None.  ``ValueError`` unless 0 <= lo <= hi
    <= w (lo == hi: an empty window, zero sums)."""
    if columns is None:
        return 0, w
    lo, hi = (int(c) for c in columns)
    if not 0 <= lo <= hi <= w:
        raise ValueError(f"columns must satisfy 0 <= lo <= hi <= {w}, got {tuple(columns)}")
    return lo, hi


def scale_columns(columns, scale: int):
    """Scale ``scale``'s window of the level-0 columns ``columns`` = (lo,
    hi): the scale's columns j with lo <= j * 2^scale < hi, (ceil(lo /
    2^scale), ceil(hi / 2^scale)); None for None."""
    if columns is None:
        return None
    m = 1 << scale
    return -(-int(columns[0]) // m), -(-int(columns[1]) // m)


def scale_sums(ref: torch.Tensor, dis: torch.Tensor, win: np.ndarray, columns=None) -> torch.Tensor:
    """One scale's (num, den) sums for (B, H, W) f32 inputs -> (B, 2) f32
    (the maps in f32, their sums in f64), over the columns [lo, hi) of
    ``columns`` (None: all of them; the maps are those of the whole
    plane either way)."""
    lo, hi = window_columns(columns, ref.shape[-1])
    mu1 = blur_same(ref, win)
    mu2 = blur_same(dis, win)
    s11 = torch.clamp_min(blur_same(ref * ref, win) - mu1 * mu1, 0.0)
    s22 = torch.clamp_min(blur_same(dis * dis, win) - mu2 * mu2, 0.0)
    s12 = blur_same(ref * dis, win) - mu1 * mu2

    eps = torch.tensor(EPS, device=ref.device)
    zero = torch.zeros((), device=ref.device)
    g = s12 / (s11 + eps)
    sv_sq = s22 - g * s12
    # Guards (order matters, mirroring the classic implementation).
    g = torch.where(s11 < eps, zero, g)
    sv_sq = torch.where(s11 < eps, s22, sv_sq)
    s11c = torch.where(s11 < eps, zero, s11)
    sv_sq = torch.where(s22 < eps, zero, sv_sq)
    g = torch.where(s22 < eps, zero, g)
    sv_sq = torch.where(g < 0.0, s22, sv_sq)
    g = torch.clamp_min(g, 0.0)
    sv_sq = torch.maximum(sv_sq, eps)

    nsq = torch.tensor(SIGMA_NSQ, device=ref.device)
    num = torch.log2(1.0 + g * g * s11c / (sv_sq + nsq))
    den = torch.log2(1.0 + s11c / nsq)
    if (lo, hi) != (0, ref.shape[-1]):
        num, den = num[..., lo:hi], den[..., lo:hi]
    return torch.stack(
        [num.double().sum(dim=(-2, -1)), den.double().sum(dim=(-2, -1))], dim=-1
    ).float()


def vif_scale_stats(ref: torch.Tensor, dis: torch.Tensor, *, backend: str | None = None, integer: bool = False,
                    depth: int = 8, columns=None) -> torch.Tensor:
    """Per-scale (num, den) sums for (B, H, W) f32 luma in 8-bit units.

    Returns (B, 4, 2): [..., k, 0] = num_k, [..., k, 1] = den_k, scale k
    summed over ``scale_columns(columns, k)`` (None: every column).

    ``backend`` (ops/routes.py): on the kernel route, (B, h, w) planes whose
    smaller side is at least 32 (JAX's gate) go to #14 and #15 as one
    stacked f32 pair (ops/kernels/vif.py ``vif_scale_stats``); anything else
    runs the plain version below.  ``integer=True`` takes the fixed-point
    conventions, the inputs then integer luma codes at ``depth`` bits:
    K-int-VIF on the kernel route for (B, h, w) planes of one shape (the
    codes as ``routes.code_pair`` makes them), else ops/integer_vif.py.
    """
    # Imported here: the kernel modules import this one.
    from turbo_metrics_tpu_torch.ops.kernels import integer_vif as k_integer_vif
    from turbo_metrics_tpu_torch.ops.kernels import vif as k_vif

    kernels = routes.kernel_route(backend, ref.device)
    if integer:
        if kernels and routes.batched_planes(ref, dis):
            return k_integer_vif.integer_vif_stats(routes.code_pair(ref, dis, depth), depth=depth, columns=columns)
        from turbo_metrics_tpu_torch.ops.integer_vif import integer_vif_stats

        return integer_vif_stats(ref, dis, depth=depth, columns=columns)
    if kernels and routes.wide_planes(ref, dis):
        return k_vif.vif_scale_stats(routes.f32_pair(ref, dis), columns=columns)
    out = []
    for k in range(NUM_SCALES):
        win = vif_window(k)
        if k > 0:
            ref = decimate2(blur_same(ref, win))
            dis = decimate2(blur_same(dis, win))
        out.append(scale_sums(ref, dis, win, scale_columns(columns, k)))
    return torch.stack(out, dim=-2)


def vif_scores(stats: np.ndarray) -> dict[str, np.ndarray]:
    """(..., 4, 2) sums -> per-scale scores + overall VIF."""
    stats = np.asarray(stats, dtype=np.float64)
    num = stats[..., 0]
    den = stats[..., 1]
    per_scale = num / np.maximum(den, 1e-30)
    overall = num.sum(axis=-1) / np.maximum(den.sum(axis=-1), 1e-30)
    return {
        **{f"vif_scale{k}": per_scale[..., k] for k in range(NUM_SCALES)},
        "vif": overall,
    }
