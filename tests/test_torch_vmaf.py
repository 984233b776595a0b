"""VMAF in the port (ops/vmaf_motion.py, ops/vif.py, ops/adm.py, the twins of
kernels #14-#18, models/vmaf_model.py, the engine and the CLI) vs the JAX
package, on the CPU.

Motion is held bit for bit against the JAX jnp path, the Pallas kernels in
interpret mode and the scalar oracle (refimpl/vmaf_motion.py).  VIF and ADM
sums are held against the JAX jnp path (jitted), scores against the f64
oracles (refimpl/vif.py, refimpl/adm.py) and VIF's Pallas kernels in
interpret mode, at the JAX package's own bars.

The port evaluates VIF and ADM in the jnp path's f32 expression order with
every multiply and add rounded on its own, as ``jnp`` does op by op.  A jitted
JAX function on the CPU contracts multiply-adds into FMAs (XLA), which moves
VIF's deep scales by up to ~1e-4 of score at these sizes (ROADMAP Queue 3):
those are held against the jnp path evaluated op by op, and the JAX engine's
at 1e-5 where the contraction leaves the value within it (vif, scale 0).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu.models import vmaf_model as jax_vmaf_model
from turbo_metrics_tpu.ops import adm as jadm
from turbo_metrics_tpu.ops import vif as jvif
from turbo_metrics_tpu.ops import vmaf_motion as jmot
from turbo_metrics_tpu.ops.pallas.vif import vif_scale_stats_pallas
from turbo_metrics_tpu.refimpl import adm as oracle_adm
from turbo_metrics_tpu.refimpl import vif as oracle_vif
from turbo_metrics_tpu.refimpl import vmaf_motion as oracle_motion

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.io.probe import create_source as port_create_source
from turbo_metrics_tpu_torch.models import vmaf_model as port_vmaf_model
from turbo_metrics_tpu_torch.ops import adm as tadm
from turbo_metrics_tpu_torch.ops import vif as tvif
from turbo_metrics_tpu_torch.ops import vmaf_motion as tmot
from turbo_metrics_tpu_torch.ops.kernels import adm as kadm
from turbo_metrics_tpu_torch.ops.kernels import motion as kmot
from turbo_metrics_tpu_torch.ops.kernels import vif as kvif

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

VIF_KEYS = ["vmaf_vif"] + [f"vmaf_vif_scale{k}" for k in range(4)]
ADM_KEYS = ["vmaf_adm"] + [f"vmaf_adm_scale{k}" for k in range(4)]
_jnp_vif = jax.jit(jvif.vif_scale_stats)
_jnp_adm = jax.jit(jadm.adm_stats)


def _sinusoid_pair(rng, h, w):
    """tests/test_pallas_kernels.py's VIF/ADM inputs: a sinusoid and a noisy
    copy, f32 in 8-bit units."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ref = (128 + 80 * np.sin(xx / 11) * np.cos(yy / 7)).astype(np.float32)
    dis = np.clip(ref + rng.normal(0, 4, ref.shape).astype(np.float32), 0, 255)
    return ref, dis


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- motion (#16 / #17 twins) ----------------------------------------------


def test_motion_constants_match_jax():
    np.testing.assert_array_equal(tmot.FILTER, jmot.FILTER)
    assert tmot.FILTER.dtype == jmot.FILTER.dtype and tmot.RADIUS == jmot.RADIUS


def _motion_case(h, w, depth, dt=None):
    """A case of test_motion_matches_jax: luma of type dt (u8 at 8 bits,
    else u16, where None), named h-w-depth[-type]."""
    name = f"{h}-{w}-{depth}" + ("" if dt is None else f"-{np.dtype(dt).name}")
    return pytest.param(h, w, depth, dt, id=name)


# Sizes where csrc/motion.cu branches: the smallest frames, widths on either
# side of a 16-byte chunk (16 u8, 8 u16, 4 int32 samples) and of a warp's
# row segment (30 chunks: 480 u8, 240 u16, 120 int32 samples), and int32
# luma codes at unaligned widths.
MOTION_EDGES = [(3, 3, 8), (5, 17, 8), (4, 15, 8), (4, 16, 8), (4, 17, 8), (6, 479, 8), (6, 481, 8),
                (5, 7, 10), (5, 9, 10), (5, 239, 10), (5, 241, 10), (9, 31, 16),
                (7, 33, 10, np.int32), (7, 121, 16, np.int32),
                # u16 and int32 rows of whole 16-byte chunks: one chunk, two,
                # one row segment and two.
                (5, 8, 10), (6, 16, 16), (5, 240, 10), (9, 480, 16), (4, 8, 16), (7, 16, 10),
                (6, 240, 16), (5, 480, 10),
                (5, 4, 10, np.int32), (6, 120, 16, np.int32), (9, 124, 10, np.int32),
                (6, 4, 16, np.int32), (5, 120, 10, np.int32), (7, 124, 16, np.int32)]


@pytest.mark.parametrize(
    "h,w,depth,dt",
    [_motion_case(*c) for c in [(96, 128, 8), (161, 300, 8), (64, 80, 10), (40, 56, 16)] + MOTION_EDGES],
)
def test_motion_matches_jax(rng, h, w, depth, dt):
    """The blur and the row SADs bit for bit against the jnp path and the
    Pallas kernels in interpret mode; kernel #16's twin takes frame b - 1's
    blur as frame b's previous frame, ``prev0`` for frame 0.  At 16 bits the
    Pallas kernel is not exact (ROADMAP Queue 3): there the scalar oracle
    stands in for it."""
    dt = dt or (np.uint8 if depth == 8 else np.uint16)
    y = rng.integers(0, 1 << depth, (2, h, w)).astype(dt)
    prev0 = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
    backends = ("jnp", "interpret") if depth < 16 else ("jnp",)
    blur = kmot.integer_blur(*_t(y), depth=depth)
    assert blur.dtype == torch.uint16 and blur.shape == (2, h, w)
    for backend in backends:
        np.testing.assert_array_equal(
            blur.numpy(), np.asarray(jmot.integer_blur(y, depth=depth, backend=backend)), err_msg=backend
        )
    if depth == 16:
        np.testing.assert_array_equal(blur[0].numpy(), oracle_motion.integer_blur(y[0], depth))
    got = kmot.motion_stats(*_t(y, prev0), depth=depth)
    np.testing.assert_array_equal(got["blurred"].numpy(), blur.numpy())
    prev = np.stack([prev0, blur[0].numpy()])
    plain = tmot.motion_stats(*_t(y, prev), depth=depth)
    np.testing.assert_array_equal(plain["blurred"].numpy(), blur.numpy())
    # The plain entries' kernel route (#16 with the per-frame prev, #17;
    # behind JAX's gate, the plain version on the smaller frames) and #16's
    # per-frame prev itself.
    routed = [tmot.motion_stats(*_t(y, prev), depth=depth, backend="pallas"),
              kmot.motion_stats(*_t(y), prev=_t(prev)[0], depth=depth)]
    np.testing.assert_array_equal(tmot.integer_blur(*_t(y), depth=depth, backend="pallas").numpy(), blur.numpy())
    for backend in backends:
        want = jmot.motion_stats(y, prev, depth=depth, backend=backend)
        for out in [got, plain] + routed:
            np.testing.assert_array_equal(out["sad_rows"].numpy(), np.asarray(want["sad_rows"]), err_msg=backend)
    for out in routed:
        np.testing.assert_array_equal(out["blurred"].numpy(), blur.numpy())
    assert got["sad_rows"].dtype == torch.int64


def test_motion_stream_matches_oracle(rng):
    """A 4-frame stream through the twins as the engine chains them (frame 0
    its own previous frame, motion 0.0) against the scalar oracle."""
    h, w = 19, 26
    y = rng.integers(0, 256, (4, h, w)).astype(np.uint8)
    first = kmot.integer_blur(*_t(y[:1]))[0]
    got = kmot.motion_stats(*_t(y), first)
    prev = None
    for i in range(4):
        blurred, sad = oracle_motion.motion_frame(y[i], prev)
        np.testing.assert_array_equal(got["blurred"][i].numpy(), blurred)
        assert int(got["sad_rows"][i].sum()) == sad
        prev = blurred
    score = tmot.motion_score(int(got["sad_rows"][1].sum()), w, h)
    assert score == jmot.motion_score(int(got["sad_rows"][1].sum()), w, h) > 0


# -- VIF (#14 / #15 twins) --------------------------------------------------


@pytest.mark.parametrize("hw", [(96, 128), (96, 1100), (161, 300)])
def test_vif_sums_match_jax(hw):
    """Per-scale (num, den) sums of #14 + #15's twins against the jnp path
    (jitted) at the JAX package's kernel-vs-jnp bar."""
    ref, dis = _sinusoid_pair(np.random.default_rng(1234), *hw)
    pair = torch.from_numpy(np.stack([ref, dis])[:, None])
    got = kvif.vif_scale_stats(pair)
    assert got.shape == (1, 4, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(_jnp_vif(ref[None], dis[None])), rtol=2e-5, atol=2e-6)
    # The plain entry by every route (the kernel route: #14 + #15's twins).
    for backend in (None, "jnp", "pallas"):
        np.testing.assert_array_equal(got.numpy(), tvif.vif_scale_stats(*pair.unbind(0), backend=backend).numpy())


def test_vif_scores_match_oracle_and_pallas():
    """Scores against the f64 oracle and the Pallas kernels (#14 then the
    fused tail #15) in interpret mode, rel 2e-4; an identical pair scores
    1.0 at every scale."""
    ref, dis = _sinusoid_pair(np.random.default_rng(1234), 161, 300)
    pair = torch.from_numpy(np.stack([ref, dis])[:, None])
    sums0, level1 = kvif.vif_scale0(pair)
    assert level1.shape == (2, 1, 81, 150)
    got = tvif.vif_scores(torch.cat([sums0[:, None], kvif.vif_tail(level1)], dim=1).numpy())
    want = oracle_vif.vif_frame(ref, dis)
    pallas = tvif.vif_scores(
        np.asarray(vif_scale_stats_pallas(ref[None], dis[None], use_tail=True, interpret=True))
    )
    for k in want:
        assert float(got[k][0]) == pytest.approx(want[k], rel=2e-4), k
        assert float(got[k][0]) == pytest.approx(float(pallas[k][0]), rel=2e-4), k
    same = tvif.vif_scores(kvif.vif_scale_stats(torch.from_numpy(np.stack([ref, ref])[:, None])).numpy())
    for k in range(4):
        assert float(same[f"vif_scale{k}"][0]) == pytest.approx(1.0, abs=1e-3)


def test_vif_window_and_borders_match_jax(rng):
    """The windows are the JAX package's, and so is the border rule: axes
    shorter than a window reflect again, as jnp.pad(mode="reflect") does
    (it raises no error), down to an axis of 1; #14 + #15's twins on a frame
    whose deep scales are that small."""
    for k in range(4):
        np.testing.assert_array_equal(tvif.vif_window(k), jvif.vif_window(k))
    for n in (1, 2, 3, 5, 12):
        for r in (1, 2, 4, 8):
            want = np.asarray(jnp.pad(jnp.arange(n), r, mode="reflect"))
            np.testing.assert_array_equal(tvif.reflect101_index(n, r).numpy(), want, err_msg=f"{n}, {r}")
    ref = rng.uniform(0, 255, (2, 12, 20)).astype(np.float32)
    dis = np.clip(ref + rng.normal(0, 6, ref.shape), 0, 255).astype(np.float32)
    got = kvif.vif_scale_stats(torch.from_numpy(np.stack([ref, dis])))
    np.testing.assert_array_equal(got.numpy(), tvif.vif_scale_stats(*_t(ref, dis)).numpy())
    assert np.isfinite(got.numpy()).all()


# -- ADM (#18 twin) ---------------------------------------------------------


def _gate_flips(ref, dis) -> int:
    """Pixels whose decoupling angle gate differs between the port and the
    jnp path (jitted), over all levels."""
    o, t = jnp.asarray(ref[None]), jnp.asarray(dis[None])
    to, tt = _t(ref[None], dis[None])
    flips = 0
    for level in range(tadm.NUM_LEVELS):
        jo, jt = jax.jit(jadm._dwt_level)(o), jax.jit(jadm._dwt_level)(t)
        po, pt = tadm.dwt_level(to), tadm.dwt_level(tt)
        gate_p = tadm.decouple(po[1:], pt[1:], level)[0].numpy()
        dp = jo[1] * jt[1] + jo[2] * jt[2]
        gate_j = np.asarray(
            (dp >= 0) & (dp * dp >= np.float32(jadm.COS_1DEG_SQ) * (jo[1] ** 2 + jo[2] ** 2) * (jt[1] ** 2 + jt[2] ** 2))
        )
        flips += int((gate_p != gate_j).sum())
        o, t, to, tt = jo[0], jt[0], po[0], pt[0]
    return flips


@pytest.mark.parametrize("hw", [(75, 101), (96, 1100)])
def test_adm_sums_match_jax(hw):
    """Cube sums of #18's twin against the jnp path (jitted), rtol 1e-4;
    75x101 has odd band sizes at every level.  A failure names the pixels
    whose angle gate flipped."""
    ref, dis = _sinusoid_pair(np.random.default_rng(1234), *hw)
    got = kadm.adm_stats(torch.from_numpy(np.stack([ref, dis])[:, None]))
    assert got.shape == (1, 4, 3, 2) and got.dtype == torch.float32
    # The plain entry by every route (the kernel route: #18's twin).
    for backend in (None, "jnp", "pallas"):
        assert torch.equal(tadm.adm_stats(*_t(ref[None], dis[None]), backend=backend), got), backend
    want = np.asarray(_jnp_adm(ref[None], dis[None]))
    if not np.allclose(got.numpy(), want, rtol=1e-4, atol=0):
        # The jitted jnp path contracts multiply-adds into FMAs, which can
        # flip the discontinuous angle gate of a near-tie pixel: name the
        # flips, then hold the sums against the jnp path op by op.
        flips = _gate_flips(ref, dis)
        assert flips > 0, "ADM sums apart from the jnp path's with no angle-gate flip"
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jadm.adm_stats(ref[None], dis[None])), rtol=1e-4, atol=0,
            err_msg=f"{flips} angle-gate flips vs the jitted jnp path",
        )


@pytest.mark.parametrize("hw", [(75, 101), (161, 300)])
def test_adm_scores_match_oracle(hw):
    """adm2 and per-scale scores against the f64 oracle within 2e-3 (the
    JAX package's bar); an identical pair gives adm2 = 1."""
    h, w = hw
    ref, dis = _sinusoid_pair(np.random.default_rng(1234), h, w)
    got = tadm.adm_score(kadm.adm_stats(torch.from_numpy(np.stack([ref, dis])[:, None])).numpy(), h, w)
    want = oracle_adm.adm_frame(ref, dis)
    for k in want:
        assert float(got[k][0]) == pytest.approx(want[k], abs=2e-3), k
    same = tadm.adm_score(kadm.adm_stats(torch.from_numpy(np.stack([ref, ref])[:, None])).numpy(), h, w)
    assert float(same["adm2"][0]) == pytest.approx(1.0, abs=1e-6)


def test_adm_constants_match_jax():
    for name in ("DB2_LO", "DB2_HI"):
        np.testing.assert_array_equal(getattr(tadm, name), getattr(jadm, name))
    for level in range(4):
        assert tadm.csf_rfactors(level) == jadm.csf_rfactors(level)
    assert tadm.band_sizes(75, 101) == jadm.band_sizes(75, 101)
    assert tadm.center_region(38, 51) == jadm.center_region(38, 51)
    stats = np.random.default_rng(5).uniform(0, 1e4, (3, 4, 3, 2))
    got, want = tadm.adm_score(stats, 75, 101), jadm.adm_score(stats, 75, 101)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the fusion model -------------------------------------------------------

FEATURES_V061 = [
    "VMAF_feature_adm2_score",
    "VMAF_feature_motion2_score",
    "VMAF_feature_vif_scale0_score",
    "VMAF_feature_vif_scale1_score",
    "VMAF_feature_vif_scale2_score",
    "VMAF_feature_vif_scale3_score",
]

SVM_TEXT = """svm_type nu_svr
kernel_type rbf
gamma 0.05
nr_class 2
total_sv 2
rho -1.25
SV
0.75 1:0.9 2:0.1 3:0.8 4:0.85 5:0.9 6:0.95
-0.25 1:0.4 2:0.6 3:0.3 4:0.35 5:0.4 6:0.45
"""


def fixture_model_dict(**overrides):
    """tests/test_vmaf_model.py's hand-built model (no libvmaf model file is
    in the repository)."""
    d = {
        "model_type": "LIBSVMNUSVR",
        "feature_names": FEATURES_V061,
        "norm_type": "linear_rescale",
        # slot 0 is the score; slots 1..6 the features
        "slopes": [0.01, 1.0, 0.5, 1.0, 1.0, 1.0, 1.0],
        "intercepts": [-0.1, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0],
        "score_clip": [0.0, 100.0],
        "model": SVM_TEXT,
    }
    d.update(overrides)
    return {"model_dict": d}


@pytest.mark.parametrize(
    "overrides",
    [{}, {"score_transform": {"p0": 1.0, "p1": 0.9, "p2": 0.001, "out_lte_in": "true"}}],
)
def test_vmaf_model_matches_jax(rng, overrides, tmp_path, monkeypatch):
    d = fixture_model_dict(**overrides)
    got = port_vmaf_model.VmafModel.from_dict(d)
    want = jax_vmaf_model.VmafModel.from_dict(d)
    assert got.feature_names == want.feature_names
    feats = {k: rng.uniform(0.2, 1.0, 7) for k in want.feature_names}
    np.testing.assert_allclose(got.predict(feats), want.predict(feats), rtol=1e-10, atol=0)
    m = rng.uniform(0, 20, 9)
    np.testing.assert_array_equal(port_vmaf_model.motion2(m), jax_vmaf_model.motion2(m))
    np.testing.assert_array_equal(port_vmaf_model.motion2(m[:1]), m[:1])
    for name in FEATURES_V061 + ["integer_adm2", "integer_motion", "integer_vif_scale0"]:
        assert port_vmaf_model.canonical_feature_name(name) == jax_vmaf_model.canonical_feature_name(name)
    path = tmp_path / "model.json"
    path.write_text(json.dumps(d))
    monkeypatch.setenv("TM_VMAF_MODEL", str(path))
    assert port_vmaf_model.find_default_model() == str(path)
    assert port_vmaf_model.VmafModel.load(str(path)).name == "model"
    assert port_vmaf_model.DEFAULT_MODEL_PATHS[0] == jax_vmaf_model.DEFAULT_MODEL_PATHS[0]


# -- engine and CLI ---------------------------------------------------------


def _frames(rng, n, w, h, *, depth=8, chroma=420, noise=2.0):
    """Smooth moving YUV frames with seeded noise at ``depth`` bits."""
    s = 1 << (depth - 8)
    yy, xx = np.mgrid[0:h, 0:w]
    cw = (w + 1) // 2
    ch = (h + 1) // 2 if chroma == 420 else h
    cy, cx = np.mgrid[0:ch, 0:cw]
    out = []
    for i in range(n):
        planes = (
            128 + 70 * np.sin(xx / 9.0 + i * 0.3) * np.cos(yy / 7.0),
            128 + 40 * np.sin(cx / 5.0 + i * 0.2),
            128 + 40 * np.cos(cy / 4.0),
        )
        out.append(tuple(
            np.clip(np.round((p + rng.normal(0, noise, p.shape)) * s), 0, 255 * s).astype(np.int64)
            for p in planes
        ))
    return out


def _write(path, frames, w, h, cs):
    dt = np.uint8 if cs in ("420",) else np.uint16
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{cs}\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(p.astype(dt).tobytes())


W, H = 160, 120
N = 5


@pytest.fixture(scope="module")
def vmaf_run(tmp_path_factory):
    """A 5-frame 8-bit 4:2:0 pair, the fixture model, and the JAX CLI's JSON
    for ``-m vmaf --batch 3`` (computed once for the module)."""
    d = tmp_path_factory.mktemp("vmaf")
    rng = np.random.default_rng(4321)
    ref = _frames(rng, N, W, H)
    dis = [tuple(np.clip(p + rng.integers(-6, 7, p.shape), 0, 255) for p in f) for f in ref]
    pr, pd, model = d / "ref.y4m", d / "dis.y4m", d / "model.json"
    _write(pr, ref, W, H, "420")
    _write(pd, dis, W, H, "420")
    # A score clip wider than libvmaf's [0, 100]: the fixture's scores of
    # this pair are not clipped, so the comparison sees them.
    model.write_text(json.dumps(fixture_model_dict(score_clip=[0.0, 1000.0])))
    args = [str(pr), str(pd), "-m", "vmaf", "--vmaf-model", str(model), "--batch", "3",
            "--output", "json", "--no-progress"]
    return args, _cli_json(jax_cli, args)


def _cli_json(mod, args):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(args) == 0
    return json.loads(out.getvalue())


def _close_features(got: dict, want: dict, jnp_scores: dict):
    """Motion exact, VIF within 1e-5 and ADM within 1e-4 of the JAX CLI's
    where XLA's FMA contraction leaves its values so (motion, vif, scale 0,
    adm2), and every VIF and ADM value of the jnp path op by op."""
    np.testing.assert_array_equal(got["vmaf_motion"]["scores"], want["vmaf_motion"]["scores"])
    assert got["vmaf_motion"]["scores"][0] == 0.0
    for k, tol in (("vmaf_vif", 1e-5), ("vmaf_vif_scale0", 1e-5), ("vmaf_adm", 1e-4)):
        np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=0, atol=tol, err_msg=k)
    for keys, tol in ((VIF_KEYS, 1e-5), (ADM_KEYS, 1e-4)):
        for k in keys:
            np.testing.assert_allclose(got[k]["scores"], jnp_scores[k], rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def jnp_scores(vmaf_run) -> dict:
    """The jnp path's VIF and ADM scores of the CLI pair, evaluated op by op
    (no FMA contraction), all frames at once."""
    srcs = [port_create_source(p) for p in vmaf_run[0][:2]]
    ys = [np.stack([s.get_frame().y for _ in range(N)]).astype(np.float32) for s in srcs]
    vif = jvif.vif_scores(np.asarray(jvif.vif_scale_stats(*ys)))
    adm = jadm.adm_score(np.asarray(jadm.adm_stats(*ys)), H, W)
    out = {f"vmaf_{k}": v for k, v in vif.items()}
    out.update({"vmaf_adm" if k == "adm2" else f"vmaf_{k}": v for k, v in adm.items()})
    return out


def test_vmaf_cli_matches_jax(vmaf_run, jnp_scores, capsys):
    """``-m vmaf --vmaf-model`` through both CLIs in batches of 3 (the motion
    state and the fuser's holdback cross the batch boundary, the last batch
    is padded): the JAX CLI's keys, frame count and values."""
    args, want = vmaf_run
    got = _cli_json(port_cli, args + ["--device", "cpu"])
    assert set(got) == set(want) and "vmaf" in got
    for k in got:
        if k != "frame_count":
            assert set(got[k]) == set(want[k]) and set(got[k]["stats"]) == set(want[k]["stats"])
    assert got["frame_count"] == want["frame_count"] == N
    _close_features(got, want, jnp_scores)
    np.testing.assert_allclose(got["vmaf"]["scores"], want["vmaf"]["scores"], rtol=0, atol=1e-4)
    assert 100.0 < min(want["vmaf"]["scores"]) and len(set(want["vmaf"]["scores"])) == N
    # CSV: the JAX CLI's columns, one row per frame.
    assert port_cli.main(args[:6] + ["--output", "csv", "--no-progress", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(",") == [k for k in port_engine.METRIC_NAMES if k in want]
    assert len(lines) == 2 * (1 + N)


def test_vmaf_compute_all_matches_jax(vmaf_run, jnp_scores):
    """The engine's compute_all with the model (fused score held back one
    frame, flushed at the end) and without (no ``vmaf`` field)."""
    args, want = vmaf_run
    model = port_vmaf_model.VmafModel.load(args[5])
    srcs = lambda: (port_create_source(args[0]), port_create_source(args[1]))  # noqa: E731
    eng = port_engine.TurboMetrics(W, H, port_engine.Metrics(vmaf=True), batch=3, device="cpu",
                                   vmaf_model=model)
    res = eng.compute_all(*srcs())
    got = {k: {"scores": getattr(res, k).scores} for k in want if k != "frame_count"}
    _close_features(got, want, jnp_scores)
    np.testing.assert_allclose(res.vmaf.scores, want["vmaf"]["scores"], rtol=0, atol=1e-4)
    bare = port_engine.TurboMetrics(W, H, port_engine.Metrics(vmaf=True), batch=3, device="cpu")
    res2 = bare.compute_all(*srcs(), prefetch=False)
    assert res2.vmaf is None and res2.vmaf_adm.scores == res.vmaf_adm.scores


def test_vmaf_reset_stream_state_and_compute_one(vmaf_run):
    """``reset_stream_state`` restarts motion at 0.0; compute_one fuses with
    motion2 == motion."""
    args, _ = vmaf_run
    model = port_vmaf_model.VmafModel.load(args[5])
    src_r, src_d = port_create_source(args[0]), port_create_source(args[1])
    cc_r, cc_d = src_r.color_characteristics(), src_d.color_characteristics()
    fr = [src_r.get_frame() for _ in range(3)]
    fd = [src_d.get_frame() for _ in range(3)]
    eng = port_engine.TurboMetrics(W, H, port_engine.Metrics(vmaf=True), batch=3, device="cpu",
                                   vmaf_model=model)
    first = eng.compute_frames(fr, cc_r, fd, cc_d)
    again = eng.compute_frames(fr, cc_r, fd, cc_d)
    assert first[0].vmaf_motion == 0.0 and again[0].vmaf_motion > 0.0
    eng.reset_stream_state()
    assert [s.vmaf_motion for s in eng.compute_frames(fr, cc_r, fd, cc_d)] == [
        s.vmaf_motion for s in first
    ]
    eng.reset_stream_state()
    one = eng.compute_one(fr[0], cc_r, fd[0], cc_d)
    feats = {"adm2": one.vmaf_adm, "motion2": one.vmaf_motion,
             **{f"vif_scale{k}": getattr(one, f"vmaf_vif_scale{k}") for k in range(4)}}
    assert one.vmaf_motion == 0.0 and one.vmaf == model.predict_one(feats)


def test_vmaf_mixed_formats_cli_matches_jax(tmp_path, capsys):
    """A 10-bit 4:2:2 reference against an 8-bit 4:2:0 encode, ``-m vmaf``
    beside XPSNR: the distorted luma aligned to 10 bits, VIF/ADM inputs
    scaled by 255/1023, the integer blur at depth 10."""
    rng = np.random.default_rng(99)
    w, h = 96, 80
    ref = _frames(rng, 4, w, h, depth=10, chroma=422)
    dis = [(np.clip(y // 4 + rng.integers(-4, 5, y.shape), 0, 255), u[::2] // 4, v[::2] // 4)
           for y, u, v in ref]
    pr, pd = tmp_path / "r422p10.y4m", tmp_path / "d420.y4m"
    _write(pr, ref, w, h, "422p10")
    _write(pd, dis, w, h, "420")
    args = [str(pr), str(pd), "-m", "vmaf", "-m", "xpsnr", "--batch", "3", "--output", "json",
            "--no-progress"]
    want = _cli_json(jax_cli, args)
    got = _cli_json(port_cli, args + ["--device", "cpu"])
    capsys.readouterr()
    assert set(got) == set(want) and "vmaf" not in got and got["frame_count"] == 4
    np.testing.assert_array_equal(got["vmaf_motion"]["scores"], want["vmaf_motion"]["scores"])
    np.testing.assert_allclose(got["xpsnr"]["scores"], want["xpsnr"]["scores"], rtol=0, atol=1e-9)
    for k in ADM_KEYS:
        np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=0, atol=1e-4, err_msg=k)
    for k in ("vmaf_vif", "vmaf_vif_scale0"):
        np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hw", [(13, 21), (67, 99), (35, 131), (1080, 1920)])
def test_vif_level_scratch_holds_partials_only(hw):
    """The VIF tile kernel keeps its five row-blurred planes and the next
    scale's rows in shared memory: a scale's device scratch is two f32
    partials per 32x8 tile of each frame, ceil(w/32) * ceil(h/8) tiles (the
    library's tm_vif_blocks; chip_smoke.py holds the two equal), and sizing
    it needs no library.  Sizes cross the 32x32 tile's edges; at 13x21 the
    17-tap window is wider than the plane."""
    h, w = hw
    bsz = 3
    nblk = math.ceil(w / 32) * math.ceil(h / 8)
    assert kvif.vif_blocks(h, w) == nblk
    parts = kvif.level_scratch(bsz, h, w, "meta")
    assert parts.numel() == bsz * nblk * 2
    assert parts.dtype == torch.float32


@pytest.mark.parametrize("hw, halo", [((5, 7), True), ((13, 21), True), ((67, 99), True),
                                      ((1080, 1920), False)])
def test_adm_level_scratch_holds_partials_only(hw, halo):
    """The ADM tile kernel keeps its row-filtered and band planes in shared
    memory: a level's device scratch is six f32 partials per 32x8 block of
    the centre region of each frame, ceil((cw - 2 left)/32) * ceil((ch -
    2 top)/8) blocks on every level (the library's tm_adm_blocks;
    chip_smoke.py holds the two equal), and sizing it needs no library.
    Where the centre region starts at the plane's first row or column on
    some level (``halo``), the mask's halo leaves the band plane there and
    the tile reads it reflected."""
    h, w = hw
    bsz = 3
    edge = False
    for ch, cw in jadm.band_sizes(h, w):
        top, _, left, _ = jadm.center_region(ch, cw)
        nblk = math.ceil((cw - 2 * left) / 32) * math.ceil((ch - 2 * top) / 8)
        assert kadm.adm_blocks(ch, cw, top, left) == nblk
        parts = kadm.level_scratch(bsz, 2 * ch, 2 * cw, "meta")
        assert parts.numel() == bsz * nblk * 6
        assert parts.dtype == torch.float32
        edge |= top == 0 or left == 0
    assert edge == halo
