"""Frame data parallelism in the port (parallel/mesh.py, the engine's
``mesh=``, parallel/dryrun.py) vs the port's unsharded engine and the JAX
package's mesh, on the CPU.

Mirrors tests/test_parallel.py::test_engine_mesh_sharding case by case on
the port's ``TurboMetrics(mesh=make_mesh(4, device="cpu"))``: four CPU
shards of one process, each shard's frames in their own upload, state
carried across the shard edges by the previous shard's last reference
frame.  Against the port's unsharded engine every score is equal, bit for
bit (each frame's sums are reduced per frame, whatever the batch; motion
is integer).  Against the JAX package's engine over four virtual devices
(shard_map, a ppermute at the shard edges) the bars are those of the
port-vs-JAX engine tests: PSNR 1e-4 dB, SSIM 1e-5, XPSNR 1e-9, VMAF motion
equal, the fused score 1e-4 (tests/test_torch_vmaf.py,
tests/test_torch_xpsnr.py), fixed-point VIF rel 2e-5 and ADM rel 5e-4
(tests/test_torch_integer.py), SSIMULACRA2 SSIM2_ATOL at 64x48 (below).
As in tests/test_torch_vmaf.py, the float VIF (1e-5) and ADM (1e-4) are held
against the JAX engine where XLA's FMA contraction leaves its values so
(vif, scale 0, adm2), and every VIF and ADM value against the jnp path
evaluated op by op.  The JAX references are computed once, in module
fixtures.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from turbo_metrics_tpu.color.characteristics import height_fallback as jax_height_fallback
from turbo_metrics_tpu.engine import Metrics as JaxMetrics
from turbo_metrics_tpu.engine import TurboMetrics as JaxTurboMetrics
from turbo_metrics_tpu.engine import _VmafFuser as JaxVmafFuser
from turbo_metrics_tpu.io.frame_source import RawFrame as JaxRawFrame
from turbo_metrics_tpu.ops import adm as jadm
from turbo_metrics_tpu.ops import vif as jvif
from turbo_metrics_tpu.parallel import mesh as jax_mesh

from turbo_metrics_tpu_torch.color.characteristics import height_fallback
from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics, _VmafFuser
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.models.ssimulacra2 import ssimulacra2_subscores
from turbo_metrics_tpu_torch.parallel import dryrun, mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

W, H = 64, 48
SHARDS = 4
# SSIMULACRA2 at 64x48 (four scales, the last 8x6): the JAX jnp path's own
# f32 error grows as frames shrink (tests/test_torch_slice.py); the port is
# 2.1e-3 of score from it on these frames.
SSIM2_ATOL = 3e-3
JAX_ATOL = {
    "psnr": 1e-4, "ssim": 1e-5, "ssimulacra2": SSIM2_ATOL, "xpsnr": 1e-9, "vmaf": 1e-4,
    "vmaf_motion": 0.0, "vmaf_vif": 1e-5, "vmaf_vif_scale0": 1e-5, "vmaf_adm": 1e-4,
}
VIF_KEYS = ["vmaf_vif"] + [f"vmaf_vif_scale{k}" for k in range(4)]
ADM_KEYS = ["vmaf_adm"] + [f"vmaf_adm_scale{k}" for k in range(4)]


def _frames(seed: int = 1234, n: int = 8):
    """test_engine_mesh_sharding's frames: random 8-bit 4:2:0 luma and
    chroma, the distorted luma within +-5."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(16, 236, (H, W), dtype=np.uint8)
        uv = rng.integers(16, 240, ((H + 1) // 2, (W + 1) // 2, 2), dtype=np.uint8)
        yd = np.clip(y.astype(np.int16) + rng.integers(-5, 6, y.shape), 0, 255).astype(np.uint8)
        out.append((y, uv, yd))
    return out


FRAMES = _frames()

# (metrics, batch, frames per compute_frames call, vmaf_integer, fused): the
# cases of test_engine_mesh_sharding, and the fixed-point and fused paths.
CASES = {
    "multi": (dict(psnr=True, ssim=True, ssimulacra2=True, xpsnr=True), 8, (8,), False, False),
    "batch_5_to_8": (dict(psnr=True, ssim=True, ssimulacra2=True, xpsnr=True), 5, (5,), False, False),
    "vmaf_xpsnr": (dict(vmaf=True, xpsnr=True), 8, (8,), False, False),
    "stream_2x4": (dict(vmaf=True), 4, (4, 4), False, False),
    "vmaf_integer": (dict(vmaf=True, xpsnr=True), 4, (4, 4), True, False),
    "fused": (dict(vmaf=True), 4, (4, 4), False, True),
}


def _run(case: str, engine_cls, metrics_cls, frame_cls, cc, fuser_cls, **kw) -> list:
    """The case's scores as dicts, batch after batch through one engine;
    the fused ones through the engine module's fuser."""
    flags, batch, calls, integer, fused = CASES[case]
    eng = engine_cls(W, H, metrics_cls(**flags), batch=batch, vmaf_integer=integer,
                     vmaf_model=dryrun.fixture_model() if fused else None, **kw)
    if "mesh" in kw:
        assert eng.batch == -(-batch // SHARDS) * SHARDS
    scores, at = [], 0
    for n in calls:
        refs = [frame_cls(y=y, uv=uv, depth=8) for y, uv, _ in FRAMES[at:at + n]]
        diss = [frame_cls(y=yd, uv=uv, depth=8) for _, uv, yd in FRAMES[at:at + n]]
        got = eng.compute_frames(refs, cc, diss, cc)
        assert len(got) == n
        scores += got
        at += n
    if fused:
        fuser = fuser_cls(eng.vmaf_model)
        out = [f for s in scores if (f := fuser.push(s)) is not None]
        out.append(fuser.flush())
        scores = out
    return [s.to_dict() for s in scores]


def _port(case: str, **kw) -> list:
    return _run(case, TurboMetrics, Metrics, RawFrame, (height_fallback(H), "limited"), _VmafFuser,
                device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_scores() -> dict:
    """Every case through the JAX engine over a mesh of 4 virtual devices."""
    if len(jax.devices()) < SHARDS:
        pytest.skip(f"needs {SHARDS} virtual JAX devices")
    jmesh = jax_mesh.make_mesh(SHARDS)
    cc = (jax_height_fallback(H), "limited")
    return {case: _run(case, JaxTurboMetrics, JaxMetrics, JaxRawFrame, cc, JaxVmafFuser, mesh=jmesh)
            for case in CASES}


@pytest.fixture(scope="module")
def jnp_vmaf() -> dict:
    """VIF's and ADM's scores of the 8 frames by the JAX package's jnp path
    evaluated op by op (no FMA contraction), all frames at once."""
    ref = np.stack([y for y, _, _ in FRAMES]).astype(np.float32)
    dis = np.stack([yd for _, _, yd in FRAMES]).astype(np.float32)
    out = {f"vmaf_{k}": v for k, v in jvif.vif_scores(np.asarray(jvif.vif_scale_stats(ref, dis))).items()}
    adm = jadm.adm_score(np.asarray(jadm.adm_stats(ref, dis)), H, W)
    out.update({"vmaf_adm" if k == "adm2" else f"vmaf_{k}": v for k, v in adm.items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_matches_unsharded(case):
    """The port's engine over four CPU shards gives the unsharded engine's
    scores bit for bit, across shard edges and batch edges (XPSNR's and
    motion's previous frame from the previous shard's last reference
    frame), with the batch rounded up to a multiple of the mesh."""
    want = _port(case)
    got = _port(case, mesh=mesh.make_mesh(SHARDS, device="cpu"))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, {k: (g[k], w.get(k)) for k in g if g[k] != w.get(k)})
    if CASES[case][0].get("vmaf"):
        assert got[0]["vmaf_motion"] == 0.0 and all(g["vmaf_motion"] > 0 for g in got[1:])


@pytest.mark.parametrize("flags", [dict(xpsnr=True), dict(psnr=True, ssim=True, xpsnr=True, vmaf=True)],
                         ids=["xpsnr", "psnr_ssim_xpsnr_vmaf"])
def test_mesh_engine_call_longer_than_batch(flags):
    """A call of 9 frames to an engine of batch 8 over two shards pads to 10
    (a multiple of the mesh), scores all 9 frames as the unsharded engine
    does, and carries frame 8 into the next call's XPSNR and motion state."""
    frames = _frames(seed=99, n=13)
    cc = (height_fallback(H), "limited")
    out = []
    for kw in ({}, dict(mesh=mesh.make_mesh(2, device="cpu"))):
        eng = TurboMetrics(W, H, Metrics(**flags), batch=8, device="cpu", **kw)
        scores = []
        for a, b in ((0, 9), (9, 13)):
            refs = [RawFrame(y=y, uv=uv, depth=8) for y, uv, _ in frames[a:b]]
            diss = [RawFrame(y=yd, uv=uv, depth=8) for _, uv, yd in frames[a:b]]
            scores += [s.to_dict() for s in eng.compute_frames(refs, cc, diss, cc)]
        out.append(scores)
    want, got = out
    assert len(got) == len(want) == 13
    for i, (g, w) in enumerate(zip(got, want)):
        assert "xpsnr" in g, (i, g)
        assert g == w, (i, {k: (g[k], w.get(k)) for k in g if g[k] != w.get(k)})


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_matches_jax_mesh(case, jax_scores, jnp_vmaf):
    """The port's engine over four CPU shards against the JAX engine over
    four virtual devices, and its float VIF and ADM against the jnp path,
    at the port-vs-JAX bars of the module docstring."""
    got = _port(case, mesh=mesh.make_mesh(SHARDS, device="cpu"))
    want = jax_scores[case]
    integer = CASES[case][3]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k, v in g.items():
            if integer and k.startswith(("vmaf_vif", "vmaf_adm")):
                tol = 2e-5 if k.startswith("vmaf_vif") else 5e-4
                assert v == pytest.approx(w[k], rel=tol, abs=tol), (i, k)
                continue
            if k in JAX_ATOL:
                assert v == pytest.approx(w[k], rel=0, abs=JAX_ATOL[k]), (i, k)
            if k in VIF_KEYS or k in ADM_KEYS:
                tol = 1e-5 if k in VIF_KEYS else 1e-4
                assert v == pytest.approx(float(jnp_vmaf[k][i]), rel=0, abs=tol), (i, k)


def test_shard_over_frames_subscores():
    """test_sharded_scores_match_single_device on the port: SSIMULACRA2
    sub-scores of four frame pairs through ``shard_over_frames`` on four CPU
    shards, within 2e-6 of one call on all four."""
    rng = np.random.default_rng(1234)
    b, h, w = 4, 32, 48
    ref = rng.random((b, 3, h, w), dtype=np.float64).astype(np.float32)
    dis = np.clip(ref + rng.normal(0, 0.05, ref.shape).astype(np.float32), 0, 1)
    fn = functools.partial(ssimulacra2_subscores, num_scales=3)
    single = fn(torch.from_numpy(ref), torch.from_numpy(dis))
    sharded = mesh.shard_over_frames(fn, mesh.make_mesh(4, device="cpu"), in_ndims=(4, 4))(ref, dis)
    assert sharded.shape == single.shape == (b, 3, 3, 2, 3)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=0, atol=2e-6)


def test_shard_over_frames_rejects_outputs_without_frames():
    """A sharded function returns per-frame values only: a scalar or a value
    of another leading size raises, naming the output; inputs are checked
    against ``in_ndims`` and must split evenly."""
    m = mesh.make_mesh(2, device="cpu")
    x = torch.arange(8.0).reshape(4, 2)
    out = mesh.shard_over_frames(lambda a: {"per_frame": a * 2, "rows": (a[:, 0],)}, m, in_ndims=(2,))(x)
    assert torch.equal(out["per_frame"], x * 2) and torch.equal(out["rows"][0], x[:, 0])
    with pytest.raises(ValueError, match=r"output\['total'\]"):
        mesh.shard_over_frames(lambda a: {"total": a.sum()}, m, in_ndims=(2,))(x)
    with pytest.raises(ValueError, match=r"output\[1\]"):
        mesh.shard_over_frames(lambda a: (a, a[:1]), m, in_ndims=(2,))(x)
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_frames(lambda a: a, m, in_ndims=(3,))(x)
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_over_frames(lambda a: a, m, in_ndims=(2,))(x[:3])


def test_split_frames_gives_equal_chunks_in_order():
    m = mesh.make_mesh(4, device="cpu")
    a = np.arange(8 * 3).reshape(8, 3)
    parts = mesh.split_frames(a, m)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert all(p.device == torch.device("cpu") for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), a)
    with pytest.raises(ValueError, match="evenly"):
        mesh.split_frames(a[:7], m)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8])
def test_pad_batch_to_mesh_matches_jax(n):
    """JAX's semantics exactly: the last frame repeated up to a multiple of
    the mesh's size, and the original length."""
    arr = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    got, got_n = mesh.pad_batch_to_mesh(arr, mesh.make_mesh(4, device="cpu"))
    want, want_n = jax_mesh.pad_batch_to_mesh(arr, jax_mesh.make_mesh(4))
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)


def test_make_mesh_devices_and_errors(monkeypatch):
    """``cpu`` repeats the CPU; ``cuda`` raises without CUDA (no fallback),
    and, with CUDA, for more devices than the machine has; ``cuda:K``
    repeats card K."""
    m = mesh.make_mesh(3, device="cpu")
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3 and m.axis == mesh.FRAME_AXIS
    assert m.distinct_devices() == (torch.device("cpu"),) and m.shard_streams() == [None] * 3
    assert mesh.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        mesh.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        for dev in ("cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA"):
                mesh.make_mesh(2, device=dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            TurboMetrics(W, H, Metrics(psnr=True), mesh=mesh.Mesh(("cuda:0", "cuda:0")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        mesh.make_mesh(3)
    with pytest.raises(ValueError, match="have 2"):
        mesh.make_mesh(2, device="cuda:2")
    assert mesh.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.make_mesh(2, device="cuda:1").devices == (torch.device("cuda", 1),) * 2
    with pytest.raises(ValueError, match="all cuda or all cpu"):
        mesh.Mesh(("cpu", "cuda:0"))


def test_dryrun_multichip_cpu():
    """The port's dry run over eight CPU shards: the multi-metric step
    through shard_over_frames, then the engine with the fused VMAF score."""
    dryrun.dryrun_multichip(8, device="cpu")


def test_entry_runs():
    fn, args = dryrun.entry("cpu")
    out = fn(*args)
    assert out.shape == (2, 3, 5, 2, 3) and torch.isfinite(out).all()
