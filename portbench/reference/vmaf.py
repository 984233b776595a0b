"""VMAF's elementary features of luma: motion, VIF and ADM.

Motion (libvmaf's integer_motion, as vmaf-cuda-kernel computes it): a
separable 5-tap integer blur (3571, 16004, 26386, 16004, 3571), the column
pass rounded and shifted by the depth, the row pass by 16, the border
mirrored (x[-i] = x[i], x[n - 1 + i] = x[n - i]); the motion of a frame is
the mean |blur - blur of the previous reference| over 256.

VIF (the pixel-domain VIF of vifp_mscale / libvmaf's float VIF) and ADM
(libvmaf's float ADM: db2 DWT, the 1-degree angle gate, Watson's CSF at
the default viewing distance, 3x3 contrast masking, cube pooling over the
centre region) take the luma in 8-bit units: codes times 255 / (2^depth -
1), the distorted aligned to the reference's depth first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MOTION_TAPS = (3571, 16004, 26386, 16004, 3571)


def _mirror(n: int, device) -> torch.Tensor:
    idx = torch.arange(-2, n + 2, device=device).abs()
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def motion_blur(y: torch.Tensor, *, depth: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, h, w) codes -> the blurred planes, in 16-bit units.  Integer
    arithmetic (``dtype`` int64) for the reference."""
    h, w = y.shape[-2:]
    x = y.to(dtype).index_select(-2, _mirror(h, y.device))
    col = sum(t * x[..., k:k + h, :] for k, t in enumerate(MOTION_TAPS))
    col = _shift(col + (1 << (depth - 1)), depth).index_select(-1, _mirror(w, y.device))
    acc = sum(t * col[..., k:k + w] for k, t in enumerate(MOTION_TAPS))
    return _shift(acc + 32768, 16)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    return x >> n if not x.is_floating_point() else torch.floor(x / (1 << n))


def motion(blur: torch.Tensor, blur_prev: torch.Tensor, sum_dtype: torch.dtype) -> np.ndarray:
    h, w = blur.shape[-2:]
    sad = (blur - blur_prev).abs().to(sum_dtype).sum(dim=(-2, -1)).double().cpu().numpy()
    return sad / (w * h) / 256.0


# -- VIF ----------------------------------------------------------------------

def _vif_window(k: int) -> list[float]:
    n = (1 << (4 - k)) + 1
    sigma = n / 5.0
    g = [math.exp(-((i - (n - 1) / 2.0) ** 2) / (2.0 * sigma * sigma)) for i in range(n)]
    return [v / sum(g) for v in g]


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    idx = torch.arange(-r, n + r, device=device).abs()
    return torch.where(idx >= n, 2 * n - 2 - idx, idx)


def _blur_same(x: torch.Tensor, win: list[float]) -> torch.Tensor:
    r = len(win) // 2
    h, w = x.shape[-2:]
    p = x.index_select(-1, _reflect101(w, r, x.device))
    x = sum(t * p[..., k:k + w] for k, t in enumerate(win))
    p = x.index_select(-2, _reflect101(h, r, x.device))
    return sum(t * p[..., k:k + h, :] for k, t in enumerate(win))


def vif(ref: torch.Tensor, dis: torch.Tensor, sum_dtype: torch.dtype) -> dict[str, np.ndarray]:
    """(B, h, w) luma in 8-bit units -> {'vif', 'vif_scale0'..'vif_scale3'}."""
    eps, sigma_nsq = 1e-10, 2.0
    nums, dens = [], []
    for k in range(4):
        win = _vif_window(k)
        if k:
            ref, dis = _blur_same(ref, win)[..., ::2, ::2], _blur_same(dis, win)[..., ::2, ::2]
        mu1, mu2 = _blur_same(ref, win), _blur_same(dis, win)
        s11 = torch.clamp_min(_blur_same(ref * ref, win) - mu1 * mu1, 0.0)
        s22 = torch.clamp_min(_blur_same(dis * dis, win) - mu2 * mu2, 0.0)
        s12 = _blur_same(ref * dis, win) - mu1 * mu2
        g = s12 / (s11 + eps)
        sv = s22 - g * s12
        low1, low2 = s11 < eps, s22 < eps
        g = torch.where(low1, 0.0, g)
        sv = torch.where(low1, s22, sv)
        s11 = torch.where(low1, 0.0, s11)
        sv = torch.where(low2, 0.0, sv)
        g = torch.where(low2, 0.0, g)
        sv = torch.where(g < 0.0, s22, sv)
        g = torch.clamp_min(g, 0.0)
        sv = torch.clamp_min(sv, eps)
        num = torch.log2(1.0 + g * g * s11 / (sv + sigma_nsq))
        den = torch.log2(1.0 + s11 / sigma_nsq)
        nums.append(num.to(sum_dtype).sum(dim=(-2, -1)).double().cpu().numpy())
        dens.append(den.to(sum_dtype).sum(dim=(-2, -1)).double().cpu().numpy())
    out = {f"vif_scale{k}": nums[k] / np.maximum(dens[k], 1e-30) for k in range(4)}
    out["vif"] = sum(nums) / np.maximum(sum(dens), 1e-30)
    return out


# -- ADM ----------------------------------------------------------------------

_S3 = math.sqrt(3.0)
DB2_LO = [v / (4.0 * math.sqrt(2.0)) for v in (1.0 + _S3, 3.0 + _S3, 3.0 - _S3, 1.0 - _S3)]
DB2_HI = [DB2_LO[3], -DB2_LO[2], DB2_LO[1], -DB2_LO[0]]


def csf_rfactors(level: int) -> tuple[float, float]:
    """1 / Watson's DWT quantization step (a 0.495, k 0.466, f0 0.401, gains
    1.0 for H and V, 0.534 diagonal) at 3 picture heights of a 1080-line
    display, for the H/V bands and the diagonal band."""
    r = 3.0 * 1080 * math.pi / 180.0

    def step(g):
        t = math.log10((2.0 ** (level + 1)) * 0.401 * g / r)
        return 2.0 * 0.495 * 10.0 ** (0.466 * t * t) / g

    return 1.0 / step(1.0), 1.0 / step(0.534)


def _dwt(x: torch.Tensor, taps: list[float], dim: int) -> torch.Tensor:
    """Analysis along ``dim``: output i reads 2i - 1 + k, half-sample
    symmetric borders, ceil(n / 2) outputs."""
    n = x.shape[dim]
    base = 2 * torch.arange((n + 1) // 2, device=x.device) - 1
    out = 0
    for k, t in enumerate(taps):
        idx = base + k
        idx = torch.where(idx < 0, -(idx + 1), idx)
        idx = torch.where(idx >= n, 2 * n - idx - 1, idx)
        out = out + t * x.index_select(dim, idx)
    return out


def _mask(x: torch.Tensor) -> torch.Tensor:
    """3x3: centre 1/15, the others 1/30, reflect-101 borders."""
    h, w = x.shape[-2:]
    p = x.index_select(-2, _reflect101(h, 1, x.device)).index_select(-1, _reflect101(w, 1, x.device))
    return sum((1.0 / 15.0 if (i, j) == (1, 1) else 1.0 / 30.0) * p[..., i:i + h, j:j + w]
               for i in range(3) for j in range(3))


def adm(ref: torch.Tensor, dis: torch.Tensor, sum_dtype: torch.dtype) -> dict[str, np.ndarray]:
    """(B, h, w) luma in 8-bit units -> {'adm2', 'adm_scale0'..'adm_scale3'}."""
    cos1_sq = math.cos(math.pi / 180.0) ** 2
    h0, w0 = ref.shape[-2:]
    o, t = ref, dis
    nums, dens = [], []
    for level in range(4):
        o_lo, o_hi = _dwt(o, DB2_LO, -1), _dwt(o, DB2_HI, -1)
        t_lo, t_hi = _dwt(t, DB2_LO, -1), _dwt(t, DB2_HI, -1)
        o_a, o_v = _dwt(o_lo, DB2_LO, -2), _dwt(o_lo, DB2_HI, -2)
        o_h, o_d = _dwt(o_hi, DB2_LO, -2), _dwt(o_hi, DB2_HI, -2)
        t_a, t_v = _dwt(t_lo, DB2_LO, -2), _dwt(t_lo, DB2_HI, -2)
        t_h, t_d = _dwt(t_hi, DB2_LO, -2), _dwt(t_hi, DB2_HI, -2)
        dot = o_h * t_h + o_v * t_v
        gate = (dot >= 0.0) & (dot * dot >= cos1_sq * (o_h ** 2 + o_v ** 2) * (t_h ** 2 + t_v ** 2))
        rf_hv, rf_d = csf_rfactors(level)
        rs, os_, thr = [], [], 0
        for ob, tb, rf in ((o_h, t_h, rf_hv), (o_v, t_v, rf_hv), (o_d, t_d, rf_d)):
            k = torch.clamp(tb / (ob + 1e-30), 0.0, 1.0)
            r = torch.where(gate, tb, k * ob)
            rs.append(rf * r)
            os_.append(rf * ob)
            thr = thr + _mask((rf * (tb - r)).abs())
        bh, bw = rs[0].shape[-2:]
        top, left = max(0, int(bh * 0.1 - 0.5)), max(0, int(bw * 0.1 - 0.5))
        stab = ((bh - 2 * top) * (bw - 2 * left) / 32.0) ** (1.0 / 3.0)
        num = den = 0.0
        for r, ob in zip(rs, os_):
            m = torch.clamp_min(r.abs() - thr, 0.0)[..., top:bh - top, left:bw - left].to(sum_dtype)
            c = ob.abs()[..., top:bh - top, left:bw - left].to(sum_dtype)
            num = num + np.cbrt((m ** 3).sum(dim=(-2, -1)).double().cpu().numpy()) + stab
            den = den + np.cbrt((c ** 3).sum(dim=(-2, -1)).double().cpu().numpy()) + stab
        nums.append(num)
        dens.append(den)
        o, t = o_a, t_a
    limit = 1e-10 * (w0 * h0) / (1920.0 * 1080.0)

    def ratio(n, d):
        n = np.where(n < limit, 0.0, n)
        d = np.where(d < limit, 0.0, d)
        return np.where(d == 0.0, 1.0, n / np.where(d == 0.0, 1.0, d))

    out = {f"adm_scale{k}": ratio(nums[k], dens[k]) for k in range(4)}
    out["adm2"] = ratio(sum(nums), sum(dens))
    return out
