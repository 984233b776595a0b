"""VIF with fixed-point (integer) conventions, the plain torch version.

The port's copy of the JAX package's ops/integer_vif.py (the schedule that
its refimpl/integer_vif.py specifies): libvmaf-style fixed point, which is
the default convention of libvmaf's VIF.  The schedule is the repository's
own 32-bit one; it is not claimed bit-identical to libvmaf's integer_vif.c.

  C1 = round(tap * 2^16), centre += 2^16 - sum(C1)     (first pass)
  C2 = round(tap * 2^12), centre += 2^12 - sum(C2)     (second pass)
  depth > 8: x = (x + 2^(d-9)) >> (d-8)                 (8-bit codes)
  vertical:   vx = (sum C1 x  + 2^7 ) >> 8    (Q8)
              vp = (sum C2 p  + 2^11) >> 12   (p in x*x, y*y, x*y)
  horizontal: mu = (sum C2 vx + 2^15) >> 16   (Q4)
              pb = (sum C2 vp + 2^3 ) >> 4    (Q8)
  moments:    s11 = max(pb_xx - mu1^2, 0), s22 likewise, s12 = pb_xy - mu1 mu2
  next scale: (sum C2 vx + 2^19) >> 20 of scale k's C1/C2, decimated [::2, ::2]

with reflect-101 borders (ops/vif.reflect101_index, which keeps reflecting
where a pad is wider than the axis, as ``jnp.pad(mode="reflect")`` does).
The JAX code computes in uint32 and relies on its wraparound: every true
blur sum is < 2^32, so the wrapped sum is exact.  Here the sums are int64
masked to 32 bits (``& 0xFFFFFFFF``) wherever the JAX code wraps, and the
int32 moments wrap as int32 does, so the planes are the JAX package's bit
for bit.  The per-pixel log2 terms are f32, in the JAX expression order.
The CUDA kernel (ops/kernels/integer_vif.py) computes the same planes.

``columns=(lo, hi)``: the owned level-0 columns whose log2 terms are summed
(None: all of them), as in the float path (ops/vif.py): scale k sums its
columns j with lo <= j * 2^k < hi, ``vif.scale_columns``.  The planes are
those of the whole input either way.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops.vif import NUM_SCALES, reflect101_index, scale_columns, vif_window, window_columns

SIGMA_NSQ_Q8 = np.float32(512.0)  # 2.0 in Q8, the float path's sigma_nsq
_M32 = 0xFFFFFFFF


def vif_coeffs_q(scale: int, bits: int) -> np.ndarray:
    """Fixed-point window: round(tap * 2^bits), the centre tap absorbing the
    rounding residue so that the taps sum to exactly 2^bits (int64)."""
    taps = vif_window(scale)
    c = np.round(taps * (1 << bits)).astype(np.int64)
    c[len(c) // 2] += (1 << bits) - c.sum()
    assert c.sum() == 1 << bits and (c >= 0).all()
    return c


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 as two's-complement wraparound does."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _corr_axis_q(x: torch.Tensor, c: np.ndarray, dim: int, rshift: int) -> torch.Tensor:
    """((sum_k c[k] x[.. k ..] + 2^(rshift-1)) mod 2^32) >> rshift along
    ``dim`` (-1 or -2), reflect-101 borders; x int64 in [0, 2^32)."""
    n = len(c)
    r = n // 2
    d = x.shape[dim]
    xp = x.index_select(dim, reflect101_index(d, r, x.device))
    acc = None
    for k in range(n):
        s = int(c[k]) * xp.narrow(dim, k, d)
        acc = s if acc is None else acc + s
    return ((acc + (1 << (rshift - 1))) & _M32) >> rshift


def integer_vif_scale_planes(ref: torch.Tensor, dis: torch.Tensor, *, depth: int = 8) -> list[dict]:
    """Per-scale integer statistic planes (int32; s* in Q8, mu* in Q4) and
    each scale's inputs ('ref', 'dis'): the exact surface.  Inputs: (..., H,
    W) integer luma."""
    x = ref.to(torch.int64) & _M32
    y = dis.to(torch.int64) & _M32
    if depth > 8:
        x = ((x + (1 << (depth - 9))) & _M32) >> (depth - 8)
        y = ((y + (1 << (depth - 9))) & _M32) >> (depth - 8)
    out = []
    for k in range(NUM_SCALES):
        c1 = vif_coeffs_q(k, 16)
        c2 = vif_coeffs_q(k, 12)
        if k > 0:
            x = _corr_axis_q(_corr_axis_q(x, c1, -2, 8), c2, -1, 20)[..., ::2, ::2]
            y = _corr_axis_q(_corr_axis_q(y, c1, -2, 8), c2, -1, 20)[..., ::2, ::2]
        mu1 = wrap_i32(_corr_axis_q(_corr_axis_q(x, c1, -2, 8), c2, -1, 16)).to(torch.int64)
        mu2 = wrap_i32(_corr_axis_q(_corr_axis_q(y, c1, -2, 8), c2, -1, 16)).to(torch.int64)

        def blur2(p):
            return wrap_i32(_corr_axis_q(_corr_axis_q(p & _M32, c2, -2, 12), c2, -1, 4)).to(torch.int64)

        pxx, pyy, pxy = blur2(x * x), blur2(y * y), blur2(x * y)
        s11 = torch.clamp_min(wrap_i32(pxx - wrap_i32(mu1 * mu1)), 0)
        s22 = torch.clamp_min(wrap_i32(pyy - wrap_i32(mu2 * mu2)), 0)
        s12 = wrap_i32(pxy - wrap_i32(mu1 * mu2))
        out.append({
            "s11": s11, "s22": s22, "s12": s12,
            "mu1": mu1.to(torch.int32), "mu2": mu2.to(torch.int32),
            "ref": wrap_i32(x), "dis": wrap_i32(y),
        })
    return out


def scale_log_sums(s11i: torch.Tensor, s22i: torch.Tensor, s12i: torch.Tensor, columns=None) -> torch.Tensor:
    """One scale's (num, den) sums from its int32 moments (B, H, W) -> (B,
    2) f32: the integer guards (s11 == 0, s22 == 0, g < 0) and the f32 log2
    terms in the JAX expression order, summed in f64 over the columns [lo,
    hi) of ``columns`` (None: all of them)."""
    lo, hi = window_columns(columns, s11i.shape[-1])
    s11 = s11i.to(torch.float32)
    s22 = s22i.to(torch.float32)
    s12 = s12i.to(torch.float32)
    zero11 = s11i == 0
    zero22 = s22i == 0
    zero = torch.zeros((), device=s11.device)
    g = torch.where(zero11, zero, s12 / torch.where(zero11, torch.ones((), device=s11.device), s11))
    sv = s22 - g * s12
    sv = torch.where(zero11, s22, sv)
    s11c = torch.where(zero11, zero, s11)
    sv = torch.where(zero22, zero, sv)
    g = torch.where(zero22, zero, g)
    sv = torch.where(g < 0.0, s22, sv)
    g = torch.clamp_min(g, 0.0)
    sv = torch.clamp_min(sv, torch.tensor(np.float32(1e-10), device=s11.device))
    nsq = torch.tensor(SIGMA_NSQ_Q8, device=s11.device)
    num = torch.log2(1.0 + g * g * s11c / (sv + nsq))
    den = torch.log2(1.0 + s11c / nsq)
    if (lo, hi) != (0, s11i.shape[-1]):
        num, den = num[..., lo:hi], den[..., lo:hi]
    return torch.stack(
        [num.double().sum(dim=(-2, -1)), den.double().sum(dim=(-2, -1))], dim=-1
    ).float()


def integer_vif_stats(ref: torch.Tensor, dis: torch.Tensor, *, depth: int = 8, columns=None) -> torch.Tensor:
    """Per-scale (num, den) sums under the integer conventions: (B, H, W)
    integer luma -> (B, 4, 2) f32, the shape and meaning of the float
    ``vif_scale_stats``, so ``vif_scores`` applies unchanged; scale k summed
    over ``scale_columns(columns, k)`` (None: every column)."""
    planes = integer_vif_scale_planes(ref, dis, depth=depth)
    return torch.stack([scale_log_sums(p["s11"], p["s22"], p["s12"], scale_columns(columns, k))
                        for k, p in enumerate(planes)], dim=-2)
