"""The port's slices end to end vs the JAX package, on the CPU.

Engines, CLIs and the golden pair.  SSIMULACRA2 scores are compared within
1e-3.  At 240x136 (six scales, odd dims from level 3 on) the JAX jnp path's
own f32 error is ~1e-4 of score against an f64 evaluation of the same chain,
the port's ~1e-5 (ops/ssim_maps.py ssim_map); on much smaller frames the JAX
path's error alone approaches 1e-3.  The multi-metric runs (256x192) hold
PSNR within 1e-4 dB and SSIM and MS-SSIM within 1e-5 (tests/
test_torch_quality.py).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_io import _write_y4m

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu import engine as jax_engine
from turbo_metrics_tpu import output as jax_output
from turbo_metrics_tpu.io.probe import create_source as jax_create_source
from turbo_metrics_tpu.refimpl.ssimulacra2 import srgb8_to_linear

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.io.probe import create_source as port_create_source
from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 240, 136


MW, MH = 256, 192
MULTI = ["-m", "ssimulacra2", "-m", "psnr", "-m", "ssim", "-m", "msssim"]
ATOL = {"ssimulacra2": 1e-3, "psnr": 1e-4, "ssim": 1e-5, "msssim": 1e-5}


def _frames(rng, n, noise, w=W, h=H):
    """Smooth YUV 4:2:0 frames with seeded noise (uint8)."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0 : (h + 1) // 2, 0 : (w + 1) // 2]
    out = []
    for i in range(n):
        y = 128 + 70 * np.sin(xx / 9.0 + i * 0.3) * np.cos(yy / 7.0)
        u = 128 + 40 * np.sin(cx / 5.0 + i * 0.2)
        v = 128 + 40 * np.cos(cy / 4.0)
        out.append(
            tuple(
                np.clip(np.round(p + rng.normal(0, noise, p.shape)), 0, 255).astype(np.uint8)
                for p in (y, u, v)
            )
        )
    return out


def _write_pair(tmp_path, rng, w, h, dis_depth=8):
    """A 3-frame Y4M pair: 8-bit reference, distorted = reference plus
    noise, at ``dis_depth`` bits (scaled code values)."""
    ref = _frames(rng, 3, 2.0, w, h)
    s = 1 << (dis_depth - 8)
    dis = [
        tuple(
            np.clip(p.astype(np.int32) * s + rng.integers(-4 * s, 4 * s + 1, p.shape), 0, 255 * s)
            for p in f
        )
        for f in ref
    ]
    pr, pd = tmp_path / "ref.y4m", tmp_path / f"dis{dis_depth}.y4m"
    _write_y4m(pr, ref, w, h)
    _write_y4m(pd, dis, w, h, depth=dis_depth)
    return str(pr), str(pd)


@pytest.fixture
def y4m_pair(tmp_path, rng):
    return _write_pair(tmp_path, rng, W, H)


@pytest.fixture(scope="module")
def multi_run(tmp_path_factory):
    """A 256x192 pair and the JAX CLI's four-metric JSON for it, computed
    once for the module (the JAX reference compiles its step per run)."""
    ref, dis = _write_pair(tmp_path_factory.mktemp("multi"), np.random.default_rng(1234), MW, MH)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main([ref, dis, *MULTI, "--output", "json", "--no-progress"]) == 0
    return ref, dis, json.loads(out.getvalue())


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _run_clis(args, capsys):
    """(JAX CLI stdout, port CLI stdout) for the same arguments."""
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert port_cli.main(args + ["--device", "cpu"]) == 0
    return want, capsys.readouterr().out


def _close_scores(got: dict, want: dict, names):
    for name in names:
        np.testing.assert_allclose(
            got[name]["scores"], want[name]["scores"], rtol=0, atol=ATOL[name], err_msg=name
        )


def _scores(engine_mod, create_source, ref, dis, opts=None, **kw):
    eng = engine_mod.TurboMetrics(W, H, engine_mod.Metrics(ssimulacra2=True), batch=2, **kw)
    res = eng.compute_all(
        create_source(ref), create_source(dis), opts or engine_mod.Options()
    )
    return res.frame_count, res.ssimulacra2.scores


@pytest.mark.parametrize("opts", [{}, {"skip": 1, "every": 2}])
def test_compute_all_matches_jax(y4m_pair, opts):
    """3 frames in batches of 2 (the last one padded): per-frame scores."""
    ref, dis = y4m_pair
    n_j, want = _scores(jax_engine, jax_create_source, ref, dis, jax_engine.Options(**opts))
    n_p, got = _scores(
        port_engine, port_create_source, ref, dis, port_engine.Options(**opts), device="cpu"
    )
    assert n_p == n_j == len(got) == (3 if not opts else 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert all(10.0 < s < 100.0 for s in got)


def test_cli_json_matches_jax(y4m_pair, capsys):
    ref, dis = y4m_pair
    args = [ref, dis, "-m", "ssimulacra2", "--output", "json", "--no-progress"]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _keys(got) == _keys(want)
    assert got["frame_count"] == want["frame_count"] == 3
    np.testing.assert_allclose(
        got["ssimulacra2"]["scores"], want["ssimulacra2"]["scores"], rtol=0, atol=1e-3
    )


def test_golden_pair():
    """The frozen golden pair of tests/test_ssimulacra2.py through the port's
    kernel route from linear RGB (kernel #3 then kernel 2; their plain twins
    on CPU)."""
    rng = np.random.default_rng(20240901)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            128 + 90 * np.sin(xx / 13.0) * np.cos(yy / 11.0),
            128 + 70 * np.cos(xx / 7.0),
            128 + 50 * np.sin((xx + yy) / 19.0),
        ],
        axis=-1,
    )
    ref8 = np.clip(base, 0, 255).astype(np.uint8)
    dis8 = np.clip(ref8.astype(np.int16) + rng.integers(-9, 10, ref8.shape), 0, 255).astype(np.uint8)
    got = Ssimulacra2(w, h, device="cpu").score_pair(srgb8_to_linear(ref8), srgb8_to_linear(dis8))
    assert got == pytest.approx(80.486135, abs=0.05)


def test_port_never_imports_jax():
    """Every module of the port imports neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, turbo_metrics_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import turbo_metrics_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'turbo_metrics_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_cuda_requested_without_cuda_raises(y4m_pair):
    """No silent CPU fallback: 'cuda' (the default) errors without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the error path needs a machine without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.TurboMetrics(W, H, port_engine.Metrics(ssimulacra2=True))
    ref, dis = y4m_pair
    assert port_cli.main([ref, dis, "--no-progress"]) == 1


NAMES = ("ssimulacra2", "psnr", "ssim", "msssim")


def test_multi_metric_compute_all_matches_jax(multi_run):
    """All four RGB families through the multi-metric route, 3 frames in
    batches of 2 (the last one padded), against the JAX CLI's per-frame
    values (its compute_all run)."""
    ref, dis, want = multi_run
    eng = port_engine.TurboMetrics(
        MW, MH, port_engine.Metrics(**{n: True for n in NAMES}), batch=2, device="cpu"
    )
    res = eng.compute_all(port_create_source(ref), port_create_source(dis))
    assert res.frame_count == want["frame_count"] == 3
    for name in NAMES:
        got = getattr(res, name).scores
        assert len(got) == 3
        np.testing.assert_allclose(got, want[name]["scores"], rtol=0, atol=ATOL[name], err_msg=name)
    assert all(30.0 < s < 60.0 for s in res.psnr.scores)
    assert all(0.5 < s < 1.0 for s in res.ssim.scores)


def test_multi_metric_cli_matches_jax(multi_run, capsys):
    """JSON and CSV of a four-metric CLI run have the JAX CLI's keys,
    columns, frame count and per-frame values."""
    ref, dis, want = multi_run
    assert port_cli.main([ref, dis, *MULTI, "--output", "json", "--no-progress", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _keys(got) == _keys(want)
    assert got["frame_count"] == want["frame_count"] == 3
    _close_scores(got, want, NAMES)
    # CSV: the JAX CLI's header (its own output module), then one row per
    # frame, streamed and again at the end.
    jax_output.Output.CSV.prepare(jax_engine.Metrics(**{n: True for n in NAMES}))
    header = capsys.readouterr().out.strip()
    assert header == "psnr,ssim,msssim,ssimulacra2"
    assert port_cli.main([ref, dis, *MULTI, "--output", "csv", "--no-progress", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * (1 + 3)
    cols = header.split(",")
    for block in (lines[:4], lines[4:]):
        assert block[0] == header
        for i, row in enumerate(block[1:]):
            np.testing.assert_allclose(
                [float(v) for v in row.split(",")], [want[c]["scores"][i] for c in cols],
                rtol=0, atol=1e-3,
            )


def test_identical_pair_psnr_inf(multi_run, capsys):
    """PSNR of an identical pair is inf in both CLIs' JSON."""
    ref = multi_run[0]
    want, got = _run_clis([ref, ref, "-m", "psnr", "-m", "ssim", "--output", "json", "--no-progress"], capsys)
    want, got = json.loads(want), json.loads(got)
    assert _keys(got) == _keys(want)
    assert got["psnr"]["scores"] == want["psnr"]["scores"] == [float("inf")] * 3
    np.testing.assert_allclose(got["ssim"]["scores"], 1.0, rtol=0, atol=1e-6)


def test_mixed_depth_pair_matches_jax(tmp_path, rng, capsys):
    """An 8-bit reference against a 10-bit distorted stream: each image is
    converted with its own spec into its slot of the pair buffer."""
    ref, dis = _write_pair(tmp_path, rng, W, H, dis_depth=10)
    want, got = _run_clis(
        [ref, dis, "-m", "psnr", "-m", "ssimulacra2", "--output", "json", "--no-progress"], capsys
    )
    want, got = json.loads(want), json.loads(got)
    assert _keys(got) == _keys(want)
    assert got["frame_count"] == want["frame_count"] == 3
    _close_scores(got, want, ("psnr", "ssimulacra2"))


def test_not_ported_yet_raises(y4m_pair, tmp_path, caplog):
    """Undecodable inputs, which raised "not ported yet" before the input
    layer was ported: a truncated IVF file and a garbage PNG raise the same
    exception type through the port's and the JAX package's create_source,
    and the port's CLI exits 1 with the input named in the log."""
    ref, _ = y4m_pair
    ivf = tmp_path / "x.ivf"
    ivf.write_bytes(b"DKIF" + bytes(60))
    png = tmp_path / "x.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    for bad in (ivf, png):
        with pytest.raises(Exception) as want:
            jax_create_source(str(bad))
        with pytest.raises(type(want.value)):
            port_create_source(str(bad))
        caplog.clear()
        with caplog.at_level("ERROR", logger="turbo_metrics_tpu_torch"):
            assert port_cli.main([ref, str(bad), "-m", "vmaf", "--device", "cpu", "--no-progress"]) == 1
        assert f"Could not read distorted {bad}" in caplog.text
