"""VMAF's fixed-point VIF and ADM in the port (ops/integer_vif.py,
ops/integer_adm.py, the twins of kernels K-int-VIF and K-int-ADM, the
engine's and the CLI's ``vmaf_integer`` route) vs the JAX package, on the
CPU.

The integer surfaces (VIF's per-scale moments, means and decimated inputs;
ADM's per-level bands and angle gate) are held bit for bit against the JAX
jnp path (jitted) and the NumPy oracles (refimpl/integer_vif.py,
refimpl/integer_adm.py), at the shapes, depths and extremes of
tests/test_integer_paths.py.  The float finishes are held at the JAX tests'
own bars: VIF sums and scores rel 2e-5, ADM 5e-4.  The JAX references are
computed once per module, in fixtures.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu.color.characteristics import ColorCharacteristics as JaxCC
from turbo_metrics_tpu.engine import Metrics as JaxMetrics
from turbo_metrics_tpu.engine import TurboMetrics as JaxTurboMetrics
from turbo_metrics_tpu.io.frame_source import RawFrame as JaxRawFrame
from turbo_metrics_tpu.ops import integer_adm as jia
from turbo_metrics_tpu.ops import integer_vif as jiv
from turbo_metrics_tpu.ops.adm import adm_score as jax_adm_score
from turbo_metrics_tpu.refimpl import integer_adm as oracle_adm
from turbo_metrics_tpu.refimpl import integer_vif as oracle_vif

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.ops import adm as tadm
from turbo_metrics_tpu_torch.ops import integer_adm as tia
from turbo_metrics_tpu_torch.ops import integer_vif as tiv
from turbo_metrics_tpu_torch.ops import vif as tvif
from turbo_metrics_tpu_torch.ops.kernels import integer_adm as kia
from turbo_metrics_tpu_torch.ops.kernels import integer_vif as kiv

from tests.test_integer_paths import _pair

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

VIF_KEYS = ("s11", "s22", "s12", "mu1", "mu2", "ref", "dis")
ADM_KEYS = ("o_h", "o_v", "o_d", "t_h", "t_v", "t_d", "angle_ok")


def _extremes(h=64, w=80):
    """tests/test_integer_paths.py's worst cases: flat 0 against flat 255, a
    0-255 checkerboard against its inverse, flat 255 against itself."""
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy + xx) % 2) * 255).astype(np.uint8)
    return {
        "flat-0-255": (np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8)),
        "checker": (checker, 255 - checker),
        "flat-255": (np.full((h, w), 255, np.uint8), np.full((h, w), 255, np.uint8)),
    }


def _cases() -> dict:
    """name -> (ref, dis, depth): the shapes of tests/test_integer_paths.py,
    10-bit input, a batch, a plane smaller than the 17-tap window (h < 9)
    and the extremes."""
    cases = {f"{h}x{w}": (*_pair(h, w, seed=1), 8) for h, w in ((72, 96), (81, 107))}
    cases["64x96-10bit"] = (*_pair(64, 96, seed=4, depth=10), 10)
    r0, d0 = _pair(64, 80, seed=5)
    r1, d1 = _pair(64, 80, seed=6)
    cases["batch2-64x80"] = (np.stack([r0, r1]), np.stack([d0, d1]), 8)
    cases["5x7"] = (*_pair(5, 7, seed=3), 8)
    cases.update({k: (r, d, 8) for k, (r, d) in _extremes().items()})
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jax_surfaces() -> dict:
    """Per case: the JAX jnp path's (jitted) and the oracles' integer VIF
    planes and ADM levels, as numpy."""
    out = {}
    for name, (ref, dis, depth) in CASES.items():
        jv = jax.jit(lambda a, b, d=depth: jiv.integer_vif_scale_planes(a, b, depth=d))(ref, dis)
        ja = jax.jit(lambda a, b, d=depth: jia.integer_adm_levels(a, b, depth=d))(ref, dis)
        out[name] = {
            "vif": [{k: np.asarray(v) for k, v in p.items()} for p in jv],
            "adm": [{k: np.asarray(v) for k, v in lv.items()} for lv in ja],
            "vif_oracle": oracle_vif.integer_vif_planes(ref, dis, depth=depth),
            "adm_oracle": oracle_adm.integer_adm_levels(ref, dis, depth=depth),
        }
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_integer_constants_match_jax():
    for k in range(4):
        for bits in (16, 12):
            np.testing.assert_array_equal(tiv.vif_coeffs_q(k, bits), oracle_vif.vif_coeffs_q(k, bits))
    for got, want in zip(tia.adm_coeffs_q(), oracle_adm.adm_coeffs_q()):
        np.testing.assert_array_equal(got, want)
    assert (tia.Q_TAPS, tia.Q_BAND) == (oracle_adm.Q_TAPS, oracle_adm.Q_BAND)
    assert tia.COS_1DEG_SQ_F32 == oracle_adm.COS_1DEG_SQ_F32 and tia.COS_1DEG_SQ_F32.dtype == np.float32
    assert tiv.SIGMA_NSQ_Q8 == jiv.SIGMA_NSQ_Q8 == oracle_vif.SIGMA_NSQ_Q8


def _single_reflection(h: int, w: int) -> bool:
    """Whether every VIF scale's window radius (8, 4, 2, 1) is below its
    plane's sides: the oracle reflects once (refimpl/integer_vif.py
    _reflect_idx), while the jnp path, like the port, keeps reflecting where
    a window is wider than the plane (ROADMAP Queue 3)."""
    for k in range(4):
        if (1 << (3 - k)) >= min(h, w):
            return False
        h, w = (h + 1) // 2, (w + 1) // 2
    return True


@pytest.mark.parametrize("name", list(CASES))
def test_integer_vif_planes_match_jax(jax_surfaces, name):
    """Every scale's s11, s22, s12, mu1, mu2 and inputs bit for bit against
    the jnp path, and against the oracle where its single reflection covers
    the windows (the port's twin takes the codes as int32, uint8 or uint16:
    the same planes)."""
    ref, dis, depth = CASES[name]
    check_oracle = _single_reflection(*ref.shape[-2:])
    got = tiv.integer_vif_scale_planes(_t(ref), _t(dis), depth=depth)
    alt = tiv.integer_vif_scale_planes(_t(ref.astype(np.int32)), _t(dis.astype(np.int32)), depth=depth)
    want, oracle = jax_surfaces[name]["vif"], jax_surfaces[name]["vif_oracle"]
    for k in range(4):
        for key in VIF_KEYS:
            g = got[k][key].numpy()
            assert g.dtype == np.int32, key
            np.testing.assert_array_equal(g, want[k][key], err_msg=f"{name} scale {k} {key}")
            if check_oracle:
                np.testing.assert_array_equal(g, oracle[k][key], err_msg=f"{name} scale {k} {key} (oracle)")
            np.testing.assert_array_equal(alt[k][key].numpy(), g)
    assert check_oracle == (name != "5x7")


@pytest.mark.parametrize("name", list(CASES))
def test_integer_adm_levels_match_jax(jax_surfaces, name):
    """Every level's six bands and the angle gate bit for bit against the
    jnp path and the oracle."""
    ref, dis, depth = CASES[name]
    got = tia.integer_adm_levels(_t(ref), _t(dis), depth=depth)
    want, oracle = jax_surfaces[name]["adm"], jax_surfaces[name]["adm_oracle"]
    for li in range(4):
        for key in ADM_KEYS:
            g = got[li][key].numpy()
            assert g.dtype == (np.bool_ if key == "angle_ok" else np.int32), key
            np.testing.assert_array_equal(g, want[li][key], err_msg=f"{name} level {li} {key}")
            np.testing.assert_array_equal(g, oracle[li][key], err_msg=f"{name} level {li} {key} (oracle)")


# -- what K-int-VIF's design rests on (csrc/integer_vif.cu) -------------------

_M32 = 0xFFFFFFFF


def test_vif_windows_are_symmetric():
    """Every scale's C1 and C2 (and so each next window, C1e and C2e) equals
    its own reverse: the kernel folds each window, c[k] (x[k] + x[2R-k]),
    and refuses one that is not."""
    for k in range(4):
        for bits in (16, 12):
            c = tiv.vif_coeffs_q(k, bits)
            assert len(c) == 2 * (8 >> k) + 1
            np.testing.assert_array_equal(c, c[::-1])


def _folded_pass(x: torch.Tensor, c: np.ndarray, dim: int, rshift: int) -> torch.Tensor:
    """The kernel's blur along ``dim``: c[R] x[i] + sum_{k<R} c[k] (x[i-R+k]
    + x[i+R-k]) in uint32 (int64 masked to 32 bits after every operation),
    then (+ 2^(rshift-1)) >> rshift; reflect-101 borders."""
    r = len(c) // 2
    d = x.shape[dim]
    xp = x.index_select(dim, tvif.reflect101_index(d, r, x.device))
    acc = int(c[r]) * xp.narrow(dim, r, d) & _M32
    for k in range(r):
        pair = (xp.narrow(dim, k, d) + xp.narrow(dim, 2 * r - k, d)) & _M32
        acc = (acc + int(c[k]) * pair) & _M32
    return ((acc + (1 << (rshift - 1))) & _M32) >> rshift


def _folded_scale(x: torch.Tensor, y: torch.Tensor, k: int) -> dict:
    """A torch model of one scale of the kernel's folded uint32 schedule on
    its inputs x, y (int64 holding uint32): the vertical planes (vx, vy,
    vxx, vyy, vxy), the moments and means, and, below scale 3, the next
    window's vertical pass (vxe, vye) and the next scale's input."""
    c1, c2 = tiv.vif_coeffs_q(k, 16), tiv.vif_coeffs_q(k, 12)
    v = {"vx": _folded_pass(x, c1, -2, 8), "vy": _folded_pass(y, c1, -2, 8)}
    for name, p in (("vxx", x * x), ("vyy", y * y), ("vxy", x * y)):
        v[name] = _folded_pass(p & _M32, c2, -2, 12)
    mu1 = tiv.wrap_i32(_folded_pass(v["vx"], c2, -1, 16)).to(torch.int64)
    mu2 = tiv.wrap_i32(_folded_pass(v["vy"], c2, -1, 16)).to(torch.int64)
    pb = {n: tiv.wrap_i32(_folded_pass(v["v" + n], c2, -1, 4)).to(torch.int64) for n in ("xx", "yy", "xy")}
    out = dict(v, s11=torch.clamp_min(tiv.wrap_i32(pb["xx"] - tiv.wrap_i32(mu1 * mu1)), 0),
               s22=torch.clamp_min(tiv.wrap_i32(pb["yy"] - tiv.wrap_i32(mu2 * mu2)), 0),
               s12=tiv.wrap_i32(pb["xy"] - tiv.wrap_i32(mu1 * mu2)), mu1=mu1.to(torch.int32), mu2=mu2.to(torch.int32))
    if k < 3:
        c1e, c2e = tiv.vif_coeffs_q(k + 1, 16), tiv.vif_coeffs_q(k + 1, 12)
        for img, z in (("x", x), ("y", y)):
            out["v" + img + "e"] = _folded_pass(z, c1e, -2, 8)
            out["next_" + img] = tiv.wrap_i32(_folded_pass(out["v" + img + "e"], c2e, -1, 20)[..., ::2, ::2])
    return out


def _scale_inputs(plane: torch.Tensor) -> torch.Tensor:
    return plane.to(torch.int64) & _M32


FOLD_CASES = {
    "u8-40x56": lambda rng: (rng.integers(0, 256, (40, 56)), rng.integers(0, 256, (40, 56)), np.uint8),
    # int32 codes over the whole range (as uint32 bits): every blur wraps.
    "wrapped-int32-24x40": lambda rng: (rng.integers(-(1 << 31), 1 << 31, (24, 40)),
                                        rng.integers(-(1 << 31), 1 << 31, (24, 40)), np.int32),
}


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_folded_vif_schedule_matches_twin(name):
    """The folded uint32 schedule (a torch model of csrc/integer_vif.cu's
    passes) equals ``integer_vif_scale_planes`` bit for bit: at scale 0,
    which emits the next scale's input, and at scale 3, on the twin's own
    scale-3 input; also where the codes wrap every 32-bit sum."""
    ref, dis, dt = FOLD_CASES[name](np.random.default_rng(41))
    r, d = _t(ref.astype(dt)), _t(dis.astype(dt))
    planes = tiv.integer_vif_scale_planes(r, d)
    got0 = _folded_scale(_scale_inputs(r), _scale_inputs(d), 0)
    for key in ("s11", "s22", "s12", "mu1", "mu2"):
        assert torch.equal(got0[key], planes[0][key]), key
    assert torch.equal(got0["next_x"], planes[1]["ref"]) and torch.equal(got0["next_y"], planes[1]["dis"])
    got3 = _folded_scale(_scale_inputs(planes[3]["ref"]), _scale_inputs(planes[3]["dis"]), 3)
    for key in ("s11", "s22", "s12", "mu1", "mu2"):
        assert torch.equal(got3[key], planes[3][key]), key


def test_narrow_instances_chosen_by_type_and_depth():
    """K-int-VIF's narrow instances (uint16 shared planes) take uint8 codes,
    whatever the depth they are read at, and nothing else."""
    z = torch.zeros((2, 1, 4, 4))
    assert kiv.narrow_codes(z.to(torch.uint8))
    assert not kiv.narrow_codes(z.to(torch.uint16)) and not kiv.narrow_codes(z.to(torch.int32))


@settings(max_examples=24, deadline=None, derandomize=True)
@given(depth=st.integers(8, 16), seed=st.integers(0, 2**32 - 1), extreme=st.booleans())
def test_vif_planes_stay_in_the_narrow_range(depth, seed, extreme):
    """For uint8 codes read at ``depth`` bits every scale's input, as the
    twin computes it, is at most 255 (at most 128 where the codes are
    pre-rounded), so the kernel's narrow instances keep the vertical planes
    (vx <= 65280, vxx, vyy, vxy <= 65025) and the next window's vertical
    pass (<= 65280) in uint16; uint16 codes < 2^depth above 8 bits
    pre-round to up to 256, whose vertical sums (up to 65536) need the wide
    instances.  ``extreme``: every code at 0 or at the largest."""
    rng = np.random.default_rng(seed)
    shape = (20, 36)
    if extreme:
        ref, dis = rng.integers(0, 2, shape) * 255, rng.integers(0, 2, shape) * 255
    else:
        ref, dis = rng.integers(0, 256, shape), rng.integers(0, 256, shape)
    planes = tiv.integer_vif_scale_planes(_t(ref.astype(np.uint8)), _t(dis.astype(np.uint8)), depth=depth)
    top = 255 if depth == 8 else 128
    for k in range(4):
        assert int(planes[k]["ref"].max()) <= top and int(planes[k]["dis"].max()) <= top
        m = _folded_scale(_scale_inputs(planes[k]["ref"]), _scale_inputs(planes[k]["dis"]), k)
        assert int(torch.stack([m["vx"], m["vy"]]).max()) <= 65280
        assert int(torch.stack([m["vxx"], m["vyy"], m["vxy"]]).max()) <= 65025
        if k < 3:
            assert int(torch.stack([m["vxe"], m["vye"]]).max()) <= 65280
    if depth > 8:
        hi = (1 << depth) - 1
        assert ((hi + (1 << (depth - 9))) >> (depth - 8)) == 256


STATS_CASES = {"96x128-b2": (2, 96, 128, 8), "67x99-10bit": (1, 67, 99, 10)}


@pytest.fixture(scope="module")
def jax_stats() -> dict:
    """Per case of STATS_CASES: the pair and the JAX jnp path's (jitted)
    integer VIF and ADM sums."""
    out = {}
    for name, (n, h, w, depth) in STATS_CASES.items():
        pairs = [_pair(h, w, seed=10 + i, depth=depth) for i in range(n)]
        ref, dis = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
        vif = jax.jit(lambda a, b, d=depth: jiv.integer_vif_stats(a, b, depth=d))(ref, dis)
        adm = jax.jit(lambda a, b, d=depth: jia.integer_adm_stats(a, b, depth=d))(ref, dis)
        out[name] = (ref, dis, depth, np.asarray(vif), np.asarray(adm))
    return out


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_integer_stats_match_jax_and_oracle(jax_stats, name):
    """The (B, 4, 2) VIF sums within rel 2e-5 and the (B, 4, 3, 2) ADM sums
    within rel 5e-4 of the jnp path; per frame the scores against the
    oracles' f64 finish at the same bars."""
    ref, dis, depth, vif_j, adm_j = jax_stats[name]
    vif = tiv.integer_vif_stats(_t(ref), _t(dis), depth=depth).numpy()
    adm = tia.integer_adm_stats(_t(ref), _t(dis), depth=depth).numpy()
    # The plain entries with integer=True by every route (the kernel route:
    # K-int-VIF's and K-int-ADM's twins).
    for backend in (None, "jnp", "pallas"):
        kw = dict(integer=True, depth=depth, backend=backend)
        np.testing.assert_array_equal(tvif.vif_scale_stats(_t(ref), _t(dis), **kw).numpy(), vif, err_msg=backend)
        np.testing.assert_array_equal(tadm.adm_stats(_t(ref), _t(dis), **kw).numpy(), adm, err_msg=backend)
    assert vif.shape == vif_j.shape and adm.shape == adm_j.shape
    np.testing.assert_allclose(vif, vif_j, rtol=2e-5, atol=0)
    np.testing.assert_allclose(adm, adm_j, rtol=5e-4, atol=0)
    h, w = ref.shape[-2:]
    vs = tvif.vif_scores(vif)
    ad = tadm.adm_score(adm, h, w)
    ad_j = jax_adm_score(adm_j, h, w)
    for i in range(ref.shape[0]):
        want_v = oracle_vif.integer_vif_frame(ref[i], dis[i], depth=depth)
        want_a = oracle_adm.integer_adm_frame(ref[i], dis[i], depth=depth)
        for k, v in want_v.items():
            assert vs[k][i] == pytest.approx(v, rel=2e-5, abs=2e-5), k
        for k, v in want_a.items():
            assert ad[k][i] == pytest.approx(v, rel=5e-4, abs=5e-4), k
            assert ad[k][i] == pytest.approx(ad_j[k][i], rel=5e-4, abs=5e-4), k


def test_integer_dispatch_and_kernel_twins():
    """On CPU tensors the kernel wrappers of K-int-VIF and K-int-ADM run
    their twins (no launch counted), for uint8, uint16 and int32 codes
    alike; the check wrappers give the twins' surfaces."""
    ref, dis = _pair(40, 56, seed=2, depth=10)
    r, d = _t(ref)[None], _t(dis)[None]
    want_v = tiv.integer_vif_stats(r, d, depth=10)
    want_a = tia.integer_adm_stats(r, d, depth=10)
    launches = (kiv.integer_vif_stats.launches, kia.integer_adm_stats.launches)
    for dt in (torch.uint16, torch.int32):
        pair = torch.stack([r, d]).to(dt)
        assert torch.equal(kiv.integer_vif_stats(pair, depth=10), want_v)
        assert torch.equal(kia.integer_adm_stats(pair, depth=10), want_a)
    assert (kiv.integer_vif_stats.launches, kia.integer_adm_stats.launches) == launches
    r8, d8 = _pair(40, 56, seed=2)
    r8, d8 = _t(r8)[None], _t(d8)[None]
    pair8 = torch.stack([r8, d8])
    assert pair8.dtype == torch.uint8
    assert torch.equal(kiv.integer_vif_stats(pair8), tiv.integer_vif_stats(r8, d8))
    assert torch.equal(kia.integer_adm_stats(pair8), tia.integer_adm_stats(r8, d8))
    for got, want in zip(kiv.integer_vif_planes(pair8), tiv.integer_vif_scale_planes(r8, d8)):
        assert all(torch.equal(got[k], want[k]) for k in VIF_KEYS)
    for got, want in zip(kia.integer_adm_levels(pair8), tia.integer_adm_levels(r8, d8)):
        assert all(torch.equal(got[k], want[k]) for k in ADM_KEYS)


def test_integer_wrappers_reject_bad_input():
    pair = torch.zeros((2, 1, 16, 16), dtype=torch.uint8)
    for bad in (pair.float(), pair[0], pair.to(torch.int64), pair.transpose(-1, -2)):
        with pytest.raises(ValueError):
            kiv.integer_vif_stats(bad)
        with pytest.raises(ValueError):
            kia.integer_adm_stats(bad)
    for depth in (0, 17):
        with pytest.raises(ValueError, match="depth"):
            kiv.integer_vif_stats(pair, depth=depth)
        with pytest.raises(ValueError, match="depth"):
            kia.integer_adm_stats(pair, depth=depth)


# -- the slice: engine and CLI ----------------------------------------------

EH, EW = 96, 128


def _engine_frames(depth_ref, depth_dis):
    """Two frame pairs of 4:2:0 YUV: the reference at depth_ref, the
    distorted image at depth_dis (a different noisy copy)."""
    rng = np.random.default_rng(11)
    refs, diss = [], []
    for i in range(2):
        y, _ = _pair(EH, EW, seed=20 + i, depth=depth_ref)
        _, yd = _pair(EH, EW, seed=30 + i, depth=depth_dis)
        uv = rng.integers(100, 156, (EH // 2, EW // 2, 2)) << (depth_ref - 8)
        uvd = rng.integers(100, 156, (EH // 2, EW // 2, 2)) << (depth_dis - 8)
        dt_r = np.uint8 if depth_ref == 8 else np.uint16
        dt_d = np.uint8 if depth_dis == 8 else np.uint16
        refs.append((y, uv.astype(dt_r)))
        diss.append((yd, uvd.astype(dt_d)))
    return refs, diss


ENGINE_CASES = ((8, 8), (10, 8))


@pytest.fixture(scope="module")
def jax_engine_scores() -> dict:
    """The JAX engine's ``compute_frames`` with ``vmaf_integer=True`` at 96x128,
    B=2, per (reference depth, distorted depth)."""
    out = {}
    cc = (JaxCC.from_code_points(1, 1, 1), "limited")
    for dr, dd in ENGINE_CASES:
        refs, diss = _engine_frames(dr, dd)
        eng = JaxTurboMetrics(EW, EH, JaxMetrics(vmaf=True), batch=2, vmaf_integer=True)
        out[(dr, dd)] = eng.compute_frames(
            [JaxRawFrame(y=y, uv=uv, depth=dr, full_range=False) for y, uv in refs], cc,
            [JaxRawFrame(y=y, uv=uv, depth=dd, full_range=False) for y, uv in diss], cc,
        )
    return out


@pytest.mark.parametrize("depths", ENGINE_CASES, ids=lambda d: f"ref{d[0]}-dis{d[1]}")
def test_engine_vmaf_integer_matches_jax(jax_engine_scores, depths):
    """``TurboMetrics(vmaf_integer=True, device="cpu")``: per frame the VIF
    features within rel 2e-5 and the ADM features within 5e-4 of the JAX
    engine's, motion equal; on the 8-bit pair also of the oracles; a 10-bit
    reference against an 8-bit distorted stream aligns the distorted luma
    to 10 bits before the pre-rounding."""
    dr, dd = depths
    refs, diss = _engine_frames(dr, dd)
    cc = (ColorCharacteristics.from_code_points(1, 1, 1), "limited")
    eng = port_engine.TurboMetrics(EW, EH, port_engine.Metrics(vmaf=True), batch=2, device="cpu",
                                   vmaf_integer=True)
    assert eng.vmaf_integer
    got = eng.compute_frames(
        [RawFrame(y=y, uv=uv, depth=dr, full_range=False) for y, uv in refs], cc,
        [RawFrame(y=y, uv=uv, depth=dd, full_range=False) for y, uv in diss], cc,
    )
    for i, (g, w) in enumerate(zip(got, jax_engine_scores[depths])):
        gd, wd = g.to_dict(), w.to_dict()
        assert set(gd) == set(wd)
        assert gd["vmaf_motion"] == wd["vmaf_motion"]
        for k in gd:
            if k.startswith("vmaf_vif") or k.startswith("vmaf_adm"):
                tol = 2e-5 if k.startswith("vmaf_vif") else 5e-4
                assert gd[k] == pytest.approx(wd[k], rel=tol, abs=tol), k
        if dr == dd == 8:
            want_v = oracle_vif.integer_vif_frame(refs[i][0], diss[i][0])
            want_a = oracle_adm.integer_adm_frame(refs[i][0], diss[i][0])
            assert gd["vmaf_vif"] == pytest.approx(want_v["vif"], rel=2e-5, abs=2e-5)
            assert gd["vmaf_adm"] == pytest.approx(want_a["adm2"], rel=5e-4, abs=5e-4)


def _write_y4m(path, frames, w, h):
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(np.clip(p, 0, 255).astype(np.uint8).tobytes())


def _cli_json(mod, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(args) == 0
    return json.loads(out.getvalue())


CW, CH, CN = 80, 64, 4


@pytest.fixture(scope="module")
def integer_cli_run(tmp_path_factory):
    """A 4-frame 8-bit 4:2:0 pair, the fixture model of tests/test_torch_vmaf.py
    and the JAX CLI's JSON for ``-m vmaf --vmaf-integer --vmaf-model``."""
    from tests.test_torch_vmaf import fixture_model_dict

    d = tmp_path_factory.mktemp("vmaf_integer")
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:CH, 0:CW]
    ref = []
    for i in range(CN):
        y = 128 + 70 * np.sin(xx / 9.0 + i * 0.3) * np.cos(yy / 7.0) + rng.normal(0, 2, (CH, CW))
        ref.append((np.round(y), np.full((CH // 2, CW // 2), 120), np.full((CH // 2, CW // 2), 136)))
    dis = [(y + rng.integers(-6, 7, y.shape), u, v) for y, u, v in ref]
    pr, pd, model = d / "ref.y4m", d / "dis.y4m", d / "model.json"
    _write_y4m(pr, ref, CW, CH)
    _write_y4m(pd, dis, CW, CH)
    model.write_text(json.dumps(fixture_model_dict(score_clip=[0.0, 1000.0])))
    args = [str(pr), str(pd), "-m", "vmaf", "--vmaf-integer", "--vmaf-model", str(model), "--batch", "3",
            "--output", "json", "--no-progress"]
    return args, _cli_json(jax_cli, args)


def test_vmaf_integer_cli_matches_jax(integer_cli_run):
    """``-m vmaf --vmaf-integer --vmaf-model`` through both CLIs in batches of
    3: the same keys and frame count, motion equal, VIF within rel 2e-5, ADM
    within 5e-4 and the fused score within 1e-3."""
    args, want = integer_cli_run
    got = _cli_json(port_cli, args + ["--device", "cpu"])
    assert set(got) == set(want) and "vmaf" in got
    assert got["frame_count"] == want["frame_count"] == CN
    np.testing.assert_array_equal(got["vmaf_motion"]["scores"], want["vmaf_motion"]["scores"])
    for k in got:
        if k.startswith("vmaf_vif") or k.startswith("vmaf_adm"):
            tol = 2e-5 if k.startswith("vmaf_vif") else 5e-4
            np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(got["vmaf"]["scores"], want["vmaf"]["scores"], rtol=0, atol=1e-3)
    # The float route on the same pair gives other VIF values: the flag routes.
    flt = _cli_json(port_cli, [a for a in args if a != "--vmaf-integer"] + ["--device", "cpu"])
    assert flt["vmaf_vif"]["scores"] != got["vmaf_vif"]["scores"]
