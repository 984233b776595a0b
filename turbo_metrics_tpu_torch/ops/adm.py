"""ADM (adm2) elementary feature, following libvmaf's float-ADM conventions.

The port's copy of the JAX package's ops/adm.py (the Detail Loss Metric of
Li, Lukin et al. 2011, in the structure of libvmaf's adm.c/adm_tools.c):

  1. 4-level 2-D Daubechies-2 DWT, orthonormal taps, symmetric half-sample
     border extension, output index i reads input ``2*i - 1 + tap`` (odd
     sizes round up, libvmaf's ``(n+1)/2`` band sizes).
  2. Decoupling per detail subband b in {H, V, D}:
     ``k = t/(o + 1e-30)`` clipped to [0, 1], restored ``r = k*o``; where the
     (H,V) gradient vectors of ref and dis agree within 1 degree — tested as
     ``dot >= 0 and dot^2 >= cos^2(1deg) * |o|^2 * |t|^2`` — the distorted
     detail is adopted verbatim (``r = t``).  Additive impairment ``a = t - r``.
  3. CSF weighting per level/orientation: reciprocal of the Watson et al.
     (1997) DWT quantization step at the default display visual resolution.
  4. Contrast masking: one threshold map per level accumulating all three
     CSF'd additive bands through a 3x3 filter with centre weight 1/15 and
     1/30 elsewhere (reflect-101 borders); masked detail
     ``max(|csf*r| - thr, 0)``.
  5. Pooling: per band, Minkowski 3-norm over the centre region plus the
     stabilising term ``cbrt(region_area / 32)``; per-scale and total scores
     are num/den with a ``1e-10 * (w*h)/(1920*1080)`` floor.

Inputs are luma in 8-bit code-value units.  ``adm_stats`` (the plain torch
version of the device half, in the JAX jnp path's f32 expression order)
returns the per-scale, per-band centre-region cube sums; ``adm_score`` runs
on the host in f64.  The CUDA kernel (ops/kernels/adm.py) computes the same
sums.  ``adm_stats`` takes its JAX namesake's keywords and routes as
ops/routes.py sets out: #18 on a CUDA tensor behind JAX's gate, and with
``integer=True`` the fixed-point sums, K-int-ADM on a CUDA tensor
(ops/kernels/integer_adm.py) and ops/integer_adm.py elsewhere.  JAX runs
jnp by default on every platform, a choice measured on the TPU; on the
card #18 is the default (ops/routes.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import routes
from turbo_metrics_tpu_torch.ops.vif import reflect101_index

NUM_LEVELS = 4
BORDER_FACTOR = 0.1
# Watson et al. (1997) DWT quantization-step model, Y channel, 9/7 wavelet
# (libvmaf dwt_7_9_YCbCr_threshold): a, k, f0, orientation gains g.
WATSON_A = 0.495
WATSON_K = 0.466
WATSON_F0 = 0.401
WATSON_G = (1.501, 1.0, 0.534, 1.0)  # indexed: approx, H/V, diagonal
NORM_VIEW_DIST = 3.0  # libvmaf DEFAULT_ADM_NORM_VIEW_DIST
REF_DISPLAY_HEIGHT = 1080  # libvmaf DEFAULT_ADM_REF_DISPLAY_HEIGHT
NUMDEN_LIMIT = 1e-10  # scaled by (w*h)/(1920*1080)
COS_1DEG_SQ = float(np.cos(np.pi / 180.0) ** 2)
DECOUPLE_EPS = 1e-30
MASK_CENTRE = np.float32(1.0 / 15.0)
MASK_EDGE = np.float32(1.0 / 30.0)

_SQRT3 = np.sqrt(3.0)
DB2_LO = np.array(
    [1.0 + _SQRT3, 3.0 + _SQRT3, 3.0 - _SQRT3, 1.0 - _SQRT3], dtype=np.float64
) / (4.0 * np.sqrt(2.0))
DB2_HI = np.array([DB2_LO[3], -DB2_LO[2], DB2_LO[1], -DB2_LO[0]], dtype=np.float64)


def dwt_quant_step(level: int, theta: int) -> float:
    """Watson DWT quantization step Q(level, orientation) at the default
    display visual resolution (56.55 px/degree)."""
    r = NORM_VIEW_DIST * REF_DISPLAY_HEIGHT * np.pi / 180.0
    g = WATSON_G[theta]
    temp = np.log10((2.0 ** (level + 1)) * WATSON_F0 * g / r)
    return float(2.0 * WATSON_A * 10.0 ** (WATSON_K * temp * temp) / g)


def csf_rfactors(level: int) -> tuple[float, float]:
    """(1/Q for H and V bands, 1/Q for the diagonal band) at a level."""
    return 1.0 / dwt_quant_step(level, 1), 1.0 / dwt_quant_step(level, 2)


def band_sizes(h: int, w: int) -> list[tuple[int, int]]:
    """Detail-band (h, w) per DWT level (libvmaf's ceil halving)."""
    out = []
    for _ in range(NUM_LEVELS):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def center_region(h: int, w: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) of the pooled centre region, libvmaf's
    ``int(dim * border_factor - 0.5)`` crop per side."""
    left = max(0, int(w * BORDER_FACTOR - 0.5))
    top = max(0, int(h * BORDER_FACTOR - 0.5))
    return top, h - top, left, w - left


def level_windows(w: int, columns=None, frame=None) -> list[tuple[int, int]]:
    """The band columns [clo, chi) that each level of a w wide plane sums.

    ``columns`` = (lo, hi): the plane's owned level-0 columns; ``frame`` =
    (x0, frame_w): the plane's first column in the frame and the frame's
    width (None: the plane is the frame, (0, w)).  Level l's band column
    j of the frame lies at level-0 column 2^(l+1) j; the owned ones, those
    with lo <= 2^(l+1) j - x0 < hi, are [ceil((x0 + lo) / 2^(l+1)),
    ceil((x0 + hi) / 2^(l+1))) in frame coordinates (with lo a multiple of
    2^(l+1), (x0 + lo) / 2^(l+1)), intersected with the frame's centre
    columns [left_l, cw_l - left_l) (``center_region`` on the frame's
    ``band_sizes``) and made plane-local (minus x0 / 2^(l+1)), an empty
    window (clo == chi) where they miss.  x0 must be a multiple of
    2^NUM_LEVELS (a column strip of the frame), so that the plane's band
    columns are the frame's at every level.  With neither argument, every
    level's centre columns."""
    x0, fw = (0, w) if frame is None else (int(frame[0]), int(frame[1]))
    lo, hi = (0, w) if columns is None else (int(columns[0]), int(columns[1]))
    a = 1 << NUM_LEVELS
    if not (0 <= lo < hi <= w and x0 >= 0 and x0 % a == 0 and x0 + w <= fw):
        raise ValueError(
            f"columns {columns} of a {w}-column plane at column {x0} of a {fw}-column frame: need 0 <= lo "
            f"< hi <= {w}, the plane inside the frame and its first column a multiple of {a}"
        )
    out = []
    for level, (_, cw) in enumerate(band_sizes(1, fw)):
        m = 1 << (level + 1)
        _, _, left, right = center_region(1, cw)
        clo = max(-(-(x0 + lo) // m), left) - x0 // m
        chi = min(-(-(x0 + hi) // m), right) - x0 // m
        out.append((clo, max(chi, clo)))
    return out


def symmetric_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Half-sample symmetric extension (x[-1] = x[0], x[n] = x[n-1]),
    period 2n, as ``jnp.pad(mode="symmetric")`` extends."""
    m = idx.remainder(2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


def _filter_dec(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """DWT analysis along ``dim`` (-1 or -2): output i correlates the taps
    against the symmetric-extended input from 2*i - 1, ceil(d/2) outputs."""
    d = x.shape[dim]
    co = (d + 1) // 2
    base = 2 * torch.arange(co, device=x.device) - 1
    acc = None
    for k, t in enumerate(taps):
        s = x.index_select(dim, symmetric_index(base + k, d)) * _f32(t, x.device)
        acc = s if acc is None else acc + s
    return acc


def dwt_level(x: torch.Tensor):
    """One 2-D db2 DWT level of (..., H, W) -> (A, H, V, D) at ceil-half size."""
    lo_r = _filter_dec(x, DB2_LO, -1)
    hi_r = _filter_dec(x, DB2_HI, -1)
    a = _filter_dec(lo_r, DB2_LO, -2)
    v = _filter_dec(lo_r, DB2_HI, -2)  # vertical detail
    h = _filter_dec(hi_r, DB2_LO, -2)  # horizontal detail
    d = _filter_dec(hi_r, DB2_HI, -2)
    return a, h, v, d


def mask_filter(x: torch.Tensor) -> torch.Tensor:
    """3x3 masking filter: centre 1/15, others 1/30, reflect-101 borders."""
    h, w = x.shape[-2], x.shape[-1]
    xp = x.index_select(-2, reflect101_index(h, 1, x.device))
    xp = xp.index_select(-1, reflect101_index(w, 1, x.device))
    acc = None
    for dy in range(3):
        for dx in range(3):
            f = _f32(MASK_CENTRE if (dy == 1 and dx == 1) else MASK_EDGE, x.device)
            s = xp[..., dy : dy + h, dx : dx + w] * f
            acc = s if acc is None else acc + s
    return acc


def decouple(o_bands, t_bands, level: int):
    """The angle gate, decoupling and CSF of one level's detail bands (H, V,
    D) -> (the gate, [csf*r], [csf*a], [csf*o]), in the jnp path's order."""
    o_h, o_v, _ = o_bands
    t_h, t_v, _ = t_bands
    dev = o_h.device
    ot_dp = o_h * t_h + o_v * t_v
    o_mag_sq = o_h * o_h + o_v * o_v
    t_mag_sq = t_h * t_h + t_v * t_v
    angle_ok = (ot_dp >= 0.0) & (ot_dp * ot_dp >= _f32(COS_1DEG_SQ, dev) * o_mag_sq * t_mag_sq)
    return (angle_ok,) + decouple_csf(o_bands, t_bands, angle_ok, level)


def decouple_csf(o_bands, t_bands, angle_ok: torch.Tensor, level: int):
    """Decoupling and CSF of one level's detail bands (H, V, D) under the
    angle gate ``angle_ok`` -> ([csf*r], [csf*a], [csf*o]), in the jnp
    path's order: the float path's and the integer path's common finish."""
    dev = angle_ok.device
    rf_hv, rf_d = csf_rfactors(level)
    eps = _f32(DECOUPLE_EPS, dev)
    csf_r, csf_a, csf_o = [], [], []
    for o_b, t_b, rf in zip(o_bands, t_bands, (rf_hv, rf_hv, rf_d)):
        rf = _f32(rf, dev)
        k = torch.clamp(t_b / (o_b + eps), 0.0, 1.0)
        r = torch.where(angle_ok, t_b, k * o_b)
        csf_r.append(rf * r)
        csf_a.append(rf * (t_b - r))
        csf_o.append(rf * o_b)
    return csf_r, csf_a, csf_o


def level_sums(csf_r, csf_a, csf_o, columns=None) -> torch.Tensor:
    """Masking and the centre-region cube sums of one level -> (B, 3, 2)
    (the maps in f32, their sums in f64): the region's rows [top, h-top)
    and its columns [left, w-left), or the band columns ``columns`` =
    (clo, chi) (``level_windows``) in their place."""
    thr = None
    for a_b in csf_a:
        m = mask_filter(a_b.abs())
        thr = m if thr is None else thr + m
    hh, ww = csf_r[0].shape[-2], csf_r[0].shape[-1]
    top, bottom, left, right = center_region(hh, ww)
    if columns is not None:
        left, right = (int(c) for c in columns)
        if not 0 <= left <= right <= ww:
            raise ValueError(f"columns must satisfy 0 <= clo <= chi <= {ww}, got {tuple(columns)}")
    bands = []
    for r_b, o_b in zip(csf_r, csf_o):
        rm = torch.clamp_min(r_b.abs() - thr, 0.0)[..., top:bottom, left:right]
        oc = o_b.abs()[..., top:bottom, left:right]
        bands.append(
            torch.stack(
                [(rm * rm * rm).double().sum(dim=(-2, -1)), (oc * oc * oc).double().sum(dim=(-2, -1))],
                dim=-1,
            )
        )
    return torch.stack(bands, dim=-2).float()


def kernel_pair(y_ref: torch.Tensor, y_dis: torch.Tensor, *, integer: bool = False, depth: int = 8):
    """(the kernel wrapper that the kernel route of ``adm_stats`` runs, the
    pair it reads), or None where a gate sends the call to the plain
    version: #18 on one stacked f32 pair for (B, h, w) planes whose smaller
    side is at least 32 (JAX's gate); with ``integer``, K-int-ADM on the
    codes of ``routes.code_pair`` for (B, h, w) planes of one shape.  Both
    wrappers also take ``columns`` and ``frame`` (ops/kernels/adm.py)."""
    # Imported here: the kernel modules import this one.
    from turbo_metrics_tpu_torch.ops.kernels import adm as k_adm
    from turbo_metrics_tpu_torch.ops.kernels import integer_adm as k_integer_adm

    if integer:
        if routes.batched_planes(y_ref, y_dis):
            pair = routes.code_pair(y_ref, y_dis, depth)
            return functools.partial(k_integer_adm.integer_adm_stats, depth=depth), pair
        return None
    if routes.wide_planes(y_ref, y_dis):
        return k_adm.adm_stats, routes.f32_pair(y_ref, y_dis)
    return None


def adm_stats(y_ref: torch.Tensor, y_dis: torch.Tensor, *, backend: str | None = None, integer: bool = False,
              depth: int = 8, windows=None) -> torch.Tensor:
    """Per-scale, per-band centre-region cube sums for (B, H, W) f32 luma.

    Returns (B, NUM_LEVELS, 3, 2): [..., b, 0] = sum |masked csf*r_b|^3,
    [..., b, 1] = sum |csf*o_b|^3 over the centre region, bands b = (H, V, D);
    ``windows``: each level's band columns in place of the region's
    (``level_windows``), None for the region's: a keyword of the plain
    version, which a call with windows runs.

    ``backend`` (ops/routes.py) and ``integer`` / ``depth`` (the
    fixed-point conventions, the inputs then integer luma codes at
    ``depth`` bits): the kernel route where ``kernel_pair`` finds a kernel,
    else the plain version below or ops/integer_adm.py's.
    """
    kernels = routes.kernel_route(backend, y_ref.device) and windows is None
    route = kernel_pair(y_ref, y_dis, integer=integer, depth=depth) if kernels else None
    if route is not None:
        fn, pair = route
        return fn(pair)
    if integer:
        from turbo_metrics_tpu_torch.ops.integer_adm import integer_adm_stats

        return integer_adm_stats(y_ref, y_dis, depth=depth, windows=windows)
    o = y_ref.to(torch.float32)
    t = y_dis.to(torch.float32)
    out = []
    for level in range(NUM_LEVELS):
        o_a, *o_bands = dwt_level(o)
        t_a, *t_bands = dwt_level(t)
        _, csf_r, csf_a, csf_o = decouple(o_bands, t_bands, level)
        out.append(level_sums(csf_r, csf_a, csf_o, None if windows is None else windows[level]))
        o, t = o_a, t_a
    return torch.stack(out, dim=-3)


def adm_score(stats: np.ndarray, height: int, width: int) -> dict[str, np.ndarray]:
    """(..., 4, 3, 2) cube sums -> {'adm2', 'adm_scale0..3'} (libvmaf adm.c
    final pooling: per-band cbrt + cbrt(area/32) stabiliser, numden floor)."""
    stats = np.asarray(stats, dtype=np.float64)
    sizes = band_sizes(height, width)
    num_scale = np.zeros(stats.shape[:-3] + (NUM_LEVELS,))
    den_scale = np.zeros_like(num_scale)
    for level, (hh, ww) in enumerate(sizes):
        top, bottom, left, right = center_region(hh, ww)
        stab = np.cbrt((bottom - top) * (right - left) / 32.0)
        num_scale[..., level] = (
            np.cbrt(np.maximum(stats[..., level, :, 0], 0.0)) + stab
        ).sum(axis=-1)
        den_scale[..., level] = (
            np.cbrt(np.maximum(stats[..., level, :, 1], 0.0)) + stab
        ).sum(axis=-1)

    limit = NUMDEN_LIMIT * (width * height) / (1920.0 * 1080.0)

    def ratio(num, den):
        num = np.where(num < limit, 0.0, num)
        den = np.where(den < limit, 0.0, den)
        return np.where(den == 0.0, 1.0, num / np.where(den == 0.0, 1.0, den))

    out = {
        f"adm_scale{k}": ratio(num_scale[..., k], den_scale[..., k])
        for k in range(NUM_LEVELS)
    }
    out["adm2"] = ratio(num_scale.sum(axis=-1), den_scale.sum(axis=-1))
    return out
