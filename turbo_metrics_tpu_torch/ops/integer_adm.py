"""ADM with fixed-point (integer) conventions, the plain torch version.

The port's copy of the JAX package's ops/integer_adm.py (the schedule that
its refimpl/integer_adm.py specifies): libvmaf-style fixed point, the
default convention of libvmaf's ADM.  The schedule is the repository's own
32-bit one; it is not claimed bit-identical to libvmaf's integer_adm.c.

  * taps: normalised db2 (DB2_LO / sqrt(2)) in Q13, the largest tap of LO
    absorbing the residue so that sum(LO) = 2^13, the largest |tap| of HI so
    that sum(HI) = 0;
  * depth > 8: x = (x + 2^(d-9)) >> (d-8); level 0's input is (x - 128) << 8
    (Q8 int32);
  * each 1-D analysis pass is (sum_k c[k] x[2i - 1 + k] + 2^12) >> 13 with
    half-sample symmetric extension and ceil(n/2) outputs, rows first, then
    the columns of the rows' rounded int32 results: A = (lo, lo), H = (hi
    rows, lo columns), V = (lo, hi), D = (hi, hi);
  * the angle gate on the bands truncated to Q2 (b >> 6, arithmetic):
    dp = oh2 th2 + ov2 tv2, omag = oh2^2 + ov2^2, tmag likewise (int32),
    gate = dp >= 0 and f32(dp) f32(dp) >= COS_1DEG_SQ_F32 (f32(omag) f32(tmag));
  * the finish is the float path's (ops/adm.decouple_csf and level_sums) on
    the bands dequantised to orthonormal units, band * 2^(level+1) / 2^8.

Int32 arithmetic is int64 here, reduced to int32 by two's-complement
wraparound where the JAX code computes in int32, so the bands and the gate
are the JAX package's bit for bit.  The CUDA kernel
(ops/kernels/integer_adm.py) computes the same bands, gate and sums.

``windows``: each level's band columns [clo, chi) summed in place of the
centre region's (ops/adm.py ``level_windows``), as in the float path; the
bands are those of the whole input either way.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops.adm import (
    DB2_HI,
    DB2_LO,
    NUM_LEVELS,
    decouple_csf,
    level_sums,
    symmetric_index,
)
from turbo_metrics_tpu_torch.ops.integer_vif import wrap_i32

Q_TAPS = 13
Q_BAND = 8
COS_1DEG_SQ_F32 = np.float32(np.cos(np.pi / 180.0) ** 2)
BANDS = ("o_h", "o_v", "o_d", "t_h", "t_v", "t_d")


def adm_coeffs_q() -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) Q13 normalised db2 taps, int64, DC-exact."""
    lo = np.round(DB2_LO / np.sqrt(2.0) * (1 << Q_TAPS)).astype(np.int64)
    lo[np.argmax(np.abs(lo))] += (1 << Q_TAPS) - lo.sum()
    hi = np.round(DB2_HI / np.sqrt(2.0) * (1 << Q_TAPS)).astype(np.int64)
    hi[np.argmax(np.abs(hi))] -= hi.sum()
    assert lo.sum() == 1 << Q_TAPS and hi.sum() == 0
    return lo, hi


def _filter_dec_q(x: torch.Tensor, c: np.ndarray, dim: int) -> torch.Tensor:
    """Integer DWT analysis along ``dim`` (-1 or -2): output i reads input
    2i - 1 + k (symmetric extension), ceil(d/2) outputs, the int32 sum
    rounded >> Q_TAPS (arithmetic).  x int64 holding int32 values."""
    d = x.shape[dim]
    co = (d + 1) // 2
    base = 2 * torch.arange(co, device=x.device) - 1
    acc = None
    for k, t in enumerate(c):
        s = int(t) * x.index_select(dim, symmetric_index(base + k, d))
        acc = s if acc is None else acc + s
    return wrap_i32(acc + (1 << (Q_TAPS - 1))).to(torch.int64) >> Q_TAPS


def _dwt_level_q(x: torch.Tensor):
    lo, hi = adm_coeffs_q()
    lo_r = _filter_dec_q(x, lo, -1)
    hi_r = _filter_dec_q(x, hi, -1)
    return (_filter_dec_q(lo_r, lo, -2), _filter_dec_q(hi_r, lo, -2),
            _filter_dec_q(lo_r, hi, -2), _filter_dec_q(hi_r, hi, -2))


def angle_gate(o_h, o_v, t_h, t_v) -> torch.Tensor:
    """The integer decoupling angle gate of int32 Q8 bands (int64 tensors)."""
    oh2, ov2, th2, tv2 = o_h >> 6, o_v >> 6, t_h >> 6, t_v >> 6
    dp = wrap_i32(wrap_i32(oh2 * th2).to(torch.int64) + wrap_i32(ov2 * tv2).to(torch.int64))
    omag = wrap_i32(wrap_i32(oh2 * oh2).to(torch.int64) + wrap_i32(ov2 * ov2).to(torch.int64))
    tmag = wrap_i32(wrap_i32(th2 * th2).to(torch.int64) + wrap_i32(tv2 * tv2).to(torch.int64))
    dpf = dp.to(torch.float32)
    cos1 = torch.tensor(COS_1DEG_SQ_F32, device=dp.device)
    return (dp >= 0) & (dpf * dpf >= cos1 * (omag.to(torch.float32) * tmag.to(torch.float32)))


def integer_adm_levels(ref: torch.Tensor, dis: torch.Tensor, *, depth: int = 8) -> list[dict]:
    """Per-level integer bands (int32 Q8), the angle gate (bool) and the A
    bands ('a_ref', 'a_dis': the next level's input, int32): the exact
    surface.  Inputs: (..., H, W) integer luma."""
    x = wrap_i32(ref.to(torch.int64)).to(torch.int64)
    y = wrap_i32(dis.to(torch.int64)).to(torch.int64)
    if depth > 8:
        x = wrap_i32(x + (1 << (depth - 9))).to(torch.int64) >> (depth - 8)
        y = wrap_i32(y + (1 << (depth - 9))).to(torch.int64) >> (depth - 8)
    o = wrap_i32((x - 128) << Q_BAND).to(torch.int64)
    t = wrap_i32((y - 128) << Q_BAND).to(torch.int64)
    out = []
    for _ in range(NUM_LEVELS):
        o_a, o_h, o_v, o_d = _dwt_level_q(o)
        t_a, t_h, t_v, t_d = _dwt_level_q(t)
        bands = dict(zip(BANDS, (o_h, o_v, o_d, t_h, t_v, t_d)))
        out.append({
            **{k: v.to(torch.int32) for k, v in bands.items()},
            "angle_ok": angle_gate(o_h, o_v, t_h, t_v),
            "a_ref": o_a.to(torch.int32), "a_dis": t_a.to(torch.int32),
        })
        o, t = o_a, t_a
    return out


def level_stats(lv: dict, level: int, columns=None) -> torch.Tensor:
    """One level's centre-region cube sums (B, 3, 2) from its integer bands
    and gate: the bands dequantised, then the float path's finish, over the
    band columns ``columns`` = (clo, chi) in place of the region's where
    given."""
    scale = np.float32((1 << (level + 1)) / (1 << Q_BAND))
    deq = {k: lv[k].to(torch.float32) * torch.tensor(scale, device=lv[k].device) for k in BANDS}
    csf = decouple_csf([deq["o_h"], deq["o_v"], deq["o_d"]], [deq["t_h"], deq["t_v"], deq["t_d"]],
                       lv["angle_ok"], level)
    return level_sums(*csf, columns=columns)


def integer_adm_stats(ref: torch.Tensor, dis: torch.Tensor, *, depth: int = 8, windows=None) -> torch.Tensor:
    """Per-scale, per-band centre-region cube sums under the integer
    conventions: (B, H, W) integer luma -> (B, 4, 3, 2), the shape and
    meaning of the float ``adm_stats``, so ``adm_score`` applies unchanged;
    ``windows``: each level's band columns in place of the region's
    (``adm.level_windows``), None for the region's."""
    levels = integer_adm_levels(ref, dis, depth=depth)
    return torch.stack([level_stats(lv, li, None if windows is None else windows[li])
                        for li, lv in enumerate(levels)], dim=-3)
