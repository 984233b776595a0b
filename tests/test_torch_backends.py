"""The port's SSIMULACRA2 backend switch and the level chain end to end vs
the JAX package, on the CPU.

Every backend name of ``ssimulacra2_subscores`` and of ``Ssimulacra2(...,
backend=)`` against the JAX module with the same backend (``jnp`` and
``jnp_iir`` against themselves, the kernel routes against the JAX package's
``interpret*`` spellings of them, which the port does not take), on independent images (well conditioned in f32,
ROADMAP Queue 3; random legal-range YUV 4:2:0 converted by the JAX package,
as tests/test_torch_kernels.py makes them) at the JAX package's own
tolerances for those routes (tests/test_pallas_kernels.py l.42, 72, 135).
``jnp_iir`` is held looser: its recursive blur is no exact FIR, so the
variance estimates of the deep scales' SSIM map sit near zero, and the JAX
package's own op-by-op and jitted evaluations of that route differ by up to
2.4e-5 absolute (5.5e-5 relative) at 48x64.  On the CPU every kernel of
the port runs its plain twin.
Kernel #4's twin against the JAX pallas3 route, which at these sizes runs
fused_tail_pallas on every level from level 0 (sub-scores of independent
images at rtol 2e-5 / atol 2e-6, scores of close pairs within 1e-3).  Then
the engine and the CLI on a frame whose level 1 is wider than kernel 2
takes (300x2200: kernel 1, then #4 on levels 1-5) against the JAX engine.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from tests.test_io import _write_y4m

import jax.numpy as jnp

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu.models.ssimulacra2 import Ssimulacra2 as JaxSsimulacra2
from turbo_metrics_tpu.ops import colorspace as j_cs

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.io.probe import create_source as port_create_source
from turbo_metrics_tpu_torch.models import ssimulacra2 as s2
from turbo_metrics_tpu_torch.models.ssimulacra2_score import postprocess_score
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.ops.kernels import fused_tail

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

SHAPES = [(48, 64), (35, 61)]  # (h, w)
# Kernel #4 from level 0 on odd sizes whose levels all fall below one 32x32
# tile (23x29) or whose first level crosses a tile's width only (17x45).
TAIL_SHAPES = [(23, 29), (17, 45)]
# Port name -> (the JAX backend it is held against, rtol, atol).
AGAINST = {
    "auto": ("auto", 2e-5, 2e-6),  # jnp on the CPU in both packages
    "jnp": ("jnp", 2e-5, 2e-6),
    "jnp_iir": ("jnp_iir", 3e-4, 3e-5),
    "pallas": ("interpret", 2e-5, 2e-6),  # test_pallas_kernels.py:42
    "pallas2": ("interpret2", 3e-5, 1e-5),  # :72
    "pallas3": ("interpret3", 3e-5, 5e-5),  # :135
}


@pytest.fixture(scope="module")
def jax_modules():
    """The JAX package's Ssimulacra2 for each backend and size (B=2),
    compiled here once for the module."""
    mods = {}
    for jb in sorted({jb for jb, _, _ in AGAINST.values()} - {"auto"}):
        for h, w in SHAPES:
            m = JaxSsimulacra2(w, h, batch=2, backend=jb)
            zeros = np.zeros((2, 3, h, w), np.float32)
            m.subscores_device(zeros, zeros).block_until_ready()
            mods[jb, (h, w)] = m
    for hw in SHAPES:
        mods["auto", hw] = mods["jnp", hw]
    return mods


@pytest.fixture(scope="module")
def tail_modules(jax_modules):
    """The JAX package's pallas3 route in interpret mode (B=2) for SHAPES and
    TAIL_SHAPES, the latter compiled here once for the module."""
    mods = {hw: jax_modules["interpret3", hw] for hw in SHAPES}
    for h, w in TAIL_SHAPES:
        m = JaxSsimulacra2(w, h, batch=2, backend="interpret3")
        zeros = np.zeros((2, 3, h, w), np.float32)
        m.subscores_device(zeros, zeros).block_until_ready()
        mods[h, w] = m
    return mods


def _independent(rng, h, w):
    """Two independent (2, 3, h, w) linear-RGB batches: seeded legal-range
    8-bit YUV 4:2:0 through the JAX package's conversion."""
    y2 = rng.integers(16, 236, (2, 2, h, w)).astype(np.uint8)
    uv2 = rng.integers(16, 241, (2, 2, (h + 1) // 2, (w + 1) // 2, 2)).astype(np.uint8)
    lin = np.array(j_cs.yuv420_to_linear_rgb(jnp.asarray(y2), jnp.asarray(uv2)))
    return lin[0], lin[1]


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("backend", list(AGAINST))
def test_subscores_backend_matches_jax(rng, jax_modules, backend, hw):
    """ssimulacra2_subscores(backend=name) against the JAX route of that name."""
    h, w = hw
    jb, rtol, atol = AGAINST[backend]
    a, b = _independent(rng, h, w)
    want = np.asarray(jax_modules[jb, hw].subscores_device(a, b))
    ns = len(scale_dims(h, w))
    got = s2.ssimulacra2_subscores(torch.from_numpy(a), torch.from_numpy(b), num_scales=ns,
                                   backend=backend)
    assert got.shape == (2, 3, ns, 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("backend", list(AGAINST))
def test_module_backend_matches_jax(rng, jax_modules, backend, hw):
    """Ssimulacra2(w, h, batch=2, backend=name): sub-scores by
    subscores_device (the JAX name, equal to forward) against the JAX module
    of that backend (B=2); auto resolves as the function's does; score_batch
    scores what forward returns."""
    h, w = hw
    jb, rtol, atol = AGAINST[backend]
    a, b = _independent(rng, h, w)
    jm = jax_modules[jb, hw]
    m = s2.Ssimulacra2(w, h, batch=2, backend=backend, device="cpu")
    resolved = s2.default_backend("cpu") if backend == "auto" else backend
    assert (m.backend, m.num_scales, m.batch) == (resolved, jm.num_scales, jm.batch)
    got = m.subscores_device(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, m(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.subscores_device(a, b)), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(m.score_batch(a, b), m.score(got))


def _tail_pair(rng, h, w, close):
    """Independent images, or close ones: the distorted image the reference
    plus noise of 0.05 (scores ~51, where the JAX routes' own f32 error at
    these sizes stays below 1e-3 of score; the port's chain is within 2e-4
    of its own f64 evaluation)."""
    a = rng.random((2, 3, h, w), dtype=np.float64).astype(np.float32)
    if close:
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    else:
        b = rng.random((2, 3, h, w), dtype=np.float64).astype(np.float32)
    return a, b


@pytest.mark.parametrize("close", [False, True])
@pytest.mark.parametrize("hw", SHAPES + TAIL_SHAPES)
def test_fused_tail_twin_matches_jax(rng, tail_modules, hw, close):
    """Kernel #4's twin from level 0 against fused_tail_pallas, reached
    through the JAX pallas3 route in interpret mode: sub-scores of
    independent images, scores of close pairs; also on odd sizes whose
    levels fall below one 32x32 tile of the CUDA kernel."""
    h, w = hw
    ns = len(scale_dims(h, w))
    assert s2.level_route(h, w, ns) == [("fused_tail", tuple(range(ns)))]
    a, b = _tail_pair(rng, h, w, close)
    want = np.asarray(tail_modules[hw].subscores_device(a, b))
    m = s2.Ssimulacra2(w, h, device="cpu")
    sums = fused_tail.fused_tail(torch.from_numpy(np.stack([a, b])), ns, m.taps, m.opsin)
    assert sums.shape == (2, ns, 3, 6) and sums.dtype == torch.float32
    got = s2.subscores_from_sums(list(sums.unbind(1)), scale_dims(h, w)).numpy()
    if close:
        np.testing.assert_allclose(postprocess_score(got), postprocess_score(want), rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_backend_names():
    """auto picks the level chain on cuda and the plain chain on the CPU; an
    unknown name raises in the function and in the module."""
    assert s2.default_backend("cpu") == "jnp"
    assert s2.default_backend(torch.device("cuda", 0)) == "pallas3"
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError, match="unknown backend"):
        s2.ssimulacra2_subscores(x, x, num_scales=2, backend="pallas4")
    with pytest.raises(ValueError, match="unknown backend"):
        s2.Ssimulacra2(16, 16, backend="mxu", device="cpu")


@pytest.mark.parametrize("name", ["interpret", "interpret2", "interpret3"])
def test_interpret_spellings_are_not_port_backends(name):
    """The JAX package's interpret-mode names select no route of the port's
    own (its CPU tensors always run the twins): both entries refuse them."""
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError, match="unknown backend"):
        s2.ssimulacra2_subscores(x, x, num_scales=2, backend=name)
    with pytest.raises(ValueError, match="unknown backend"):
        s2.Ssimulacra2(16, 16, backend=name, device="cpu")


WIDE_W, WIDE_H = 2200, 300


@pytest.fixture(scope="module")
def wide_run(tmp_path_factory):
    """A 2-frame 300x2200 4:2:0 pair (the distorted stream the reference
    plus noise) and the JAX CLI's SSIMULACRA2 for it."""
    rng = np.random.default_rng(2200)
    yy, xx = np.mgrid[0:WIDE_H, 0:WIDE_W]
    cy, cx = np.mgrid[0 : WIDE_H // 2, 0 : WIDE_W // 2]
    ref, dis = [], []
    for i in range(2):
        planes = (128 + 70 * np.sin(xx / 9.0 + i) * np.cos(yy / 7.0),
                  128 + 40 * np.sin(cx / 5.0), 128 + 40 * np.cos(cy / 4.0))
        r = tuple(np.clip(np.round(p + rng.normal(0, 2.0, p.shape)), 0, 255) for p in planes)
        ref.append(r)
        dis.append(tuple(np.clip(p + rng.integers(-4, 5, p.shape), 0, 255) for p in r))
    d = tmp_path_factory.mktemp("wide")
    paths = str(d / "ref.y4m"), str(d / "dis.y4m")
    for path, frames in zip(paths, (ref, dis)):
        _write_y4m(path, frames, WIDE_W, WIDE_H)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main([*paths, "-m", "ssimulacra2", "--output", "json", "--no-progress"]) == 0
    return paths, json.loads(out.getvalue())["ssimulacra2"]["scores"]


def test_wide_frame_engine_matches_jax(wide_run, monkeypatch):
    """The engine routes level 1 (150x1100, wider than kernel 2 takes)
    through kernel #4 for levels 1-5, once per batch, and scores as the JAX
    engine does."""
    (ref, dis), want = wide_run
    assert s2.level_route(150, 1100, 6, 1) == [("fused_tail", (1, 2, 3, 4, 5))]
    calls = []
    for name in ("fused_tail", "fused_pyramid_tail", "fused_scale_rgb"):
        fn = getattr(s2, name)

        def rec(p12, num, *args, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(p12.shape[-2:])))
            return _fn(p12, num, *args, **kw)

        monkeypatch.setattr(s2, name, rec)
    eng = port_engine.TurboMetrics(WIDE_W, WIDE_H, port_engine.Metrics(ssimulacra2=True), batch=2,
                                   device="cpu")
    res = eng.compute_all(port_create_source(ref), port_create_source(dis))
    assert res.frame_count == 2
    assert calls == [("fused_tail", (150, 1100))]
    np.testing.assert_allclose(res.ssimulacra2.scores, want, rtol=0, atol=1e-3)


def test_wide_frame_cli_matches_jax(wide_run, capsys):
    (ref, dis), want = wide_run
    assert port_cli.main([ref, dis, "-m", "ssimulacra2", "--output", "json", "--no-progress",
                          "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["frame_count"] == 2
    np.testing.assert_allclose(got["ssimulacra2"]["scores"], want, rtol=0, atol=1e-3)
