"""XPSNR in the port (ops/xpsnr_ops.py, kernel #13's twin, the engine and the
CLI) vs the JAX package, on the CPU.

The block grids are held bit for bit (``assert_array_equal``) against the JAX
jnp path, the Pallas kernel in interpret mode where its gate holds (3-D,
min side >= 32, depth <= 12) and the NumPy oracle (refimpl/xpsnr.py, whose
int64 sums do not wrap: compared mod 2^32).  dB values are held within
1e-9 of the JAX engine's and the oracle's.
"""

import json

import numpy as np
import pytest
import torch

import jax

from tests.test_io import _write_y4m

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu import engine as jax_engine
from turbo_metrics_tpu.color.characteristics import height_fallback as jax_height_fallback
from turbo_metrics_tpu.io.frame_source import RawFrame as JaxRawFrame
from turbo_metrics_tpu.ops import xpsnr_ops as jx
from turbo_metrics_tpu.refimpl import xpsnr as oracle

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.color.characteristics import height_fallback
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.ops import xpsnr_ops as tx
from turbo_metrics_tpu_torch.ops.kernels import xpsnr as kx
from turbo_metrics_tpu_torch.tools.edge_cases import XPSNR_EDGE_CASES, XPSNR_LUMA

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

U32 = 0xFFFFFFFF
_jnp_stats = jax.jit(jx.xpsnr_block_stats)


def _planes(rng, shape, depth, *, wrap=False):
    """Seeded (ref, dis, prev) luma planes; with ``wrap`` the distorted
    plane is the reference's complement, so that 16-bit block SSEs pass
    2^32."""
    hi = 1 << depth
    dt = np.uint8 if depth == 8 else np.uint16
    ref = rng.integers(0, hi, shape).astype(dt)
    dis = (hi - 1 - ref).astype(dt) if wrap else rng.integers(0, hi, shape).astype(dt)
    prev = rng.integers(0, hi, shape).astype(dt)
    return ref, dis, prev


def _assert_grids(got: dict, want: dict):
    assert set(got) == set(want) == {"sse", "sact", "tact"}
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_constants_match_jax():
    """The highpass taps and the block size are the JAX package's."""
    np.testing.assert_array_equal(tx.HIGHPASS, jx.HIGHPASS)
    assert tx.HIGHPASS.dtype == jx.HIGHPASS.dtype
    assert tx.BLOCK == jx.BLOCK == 16


# (h, w, depth, wrap): partial edge blocks; sides under 32 (no Pallas gate);
# 10 and 12 bits; 16 bits with errors large enough that the SSE wraps.
GRID_CASES = [
    (52, 70, 8, False), (20, 28, 8, False), (52, 70, 10, False), (33, 47, 12, False),
    (40, 48, 16, True),
]


@pytest.mark.parametrize("h,w,depth,wrap", GRID_CASES)
def test_block_stats_match_jax(rng, h, w, depth, wrap):
    ref, dis, prev = _planes(rng, (2, h, w), depth, wrap=wrap)
    got = tx.xpsnr_block_stats(*(torch.from_numpy(a) for a in (ref, dis, prev)))
    assert all(g.shape == (2, -(-h // 16), -(-w // 16)) for g in got.values())
    _assert_grids({k: v.numpy() for k, v in got.items()}, _jnp_stats(ref, dis, prev))
    if min(h, w) >= 32 and depth <= 12:
        _assert_grids(
            {k: v.numpy() for k, v in got.items()},
            jx.xpsnr_block_stats(ref, dis, prev, depth=depth, backend="interpret"),
        )
    if wrap:
        assert int(got["sse"].max()) < 1 << 32
        assert (oracle.block_sums((ref[0].astype(np.int64) - dis[0]) ** 2) >= 1 << 32).any()
    for i in range(2):
        r = ref[i].astype(np.int64)
        np.testing.assert_array_equal(got["sse"][i].numpy(), oracle.block_sums((r - dis[i]) ** 2) & U32)
        np.testing.assert_array_equal(got["sact"][i].numpy(), oracle.block_sums(oracle.highpass_abs(ref[i])))
        np.testing.assert_array_equal(got["tact"][i].numpy(), oracle.block_sums(np.abs(r - prev[i])))


def test_reference_micro_case():
    """The reference's micro-test (xpsnr-cuda/src/lib.rs:206-231): 4x4
    all-16 ref vs all-14 dis, all-16 prev -> SSE 64, no activity."""
    ref = torch.full((1, 4, 4), 16, dtype=torch.uint8)
    dis = torch.full((1, 4, 4), 14, dtype=torch.uint8)
    for stats in (tx.xpsnr_block_stats(ref, dis, ref), kx.xpsnr_block_stats(ref, dis, ref[0])):
        assert [int(stats[k].sum()) for k in ("sse", "tact", "sact")] == [64, 0, 0]


# Kernel #13's interface: (reference type and depth, distorted type and
# depth).  The distorted luma is aligned to the reference's depth, and
# frame b's previous frame is reference b - 1 (frame 0's is prev0).
TWIN_CASES = [(8, 8), (10, 8), (8, 10), (16, 8), ("rgb", 10)]


@pytest.mark.parametrize("ref_depth,dis_depth", TWIN_CASES)
def test_kernel_twin_matches_jax(rng, ref_depth, dis_depth):
    h, w, bsz = 37, 50, 3
    if ref_depth == "rgb":
        ref = rng.integers(0, 256, (bsz, h, w)).astype(np.int32)  # luma codes
        prev0 = rng.integers(0, 256, (h, w)).astype(np.int32)
        ref_depth = 8
    else:
        ref, _, _ = _planes(rng, (bsz, h, w), ref_depth)
        prev0 = _planes(rng, (h, w), ref_depth)[0]
    dis = _planes(rng, (bsz, h, w), dis_depth)[1]
    got = kx.xpsnr_block_stats(
        *(torch.from_numpy(a) for a in (ref, dis, prev0)), dis_shift=ref_depth - dis_depth
    )
    dis_aligned = np.asarray(jax_engine._align_luma_depth(dis, dis_depth, ref_depth))
    prev = np.concatenate([prev0[None], ref[:-1]])
    _assert_grids({k: v.numpy() for k, v in got.items()}, _jnp_stats(ref, dis_aligned, prev))


@pytest.mark.parametrize("h,w,ref_type,dis_type", XPSNR_EDGE_CASES)
def test_kernel_twin_at_branch_points_matches_jax(rng, h, w, ref_type, dis_type):
    """Kernel #13's twin on two frames, the second taking the first as its
    previous frame, against the jnp path at the sizes where the kernel
    branches (the distorted stream aligned to the reference's depth)."""
    (ref_dt, ref_depth), (dis_dt, dis_depth) = XPSNR_LUMA[ref_type], XPSNR_LUMA[dis_type]
    ref = rng.integers(0, 1 << ref_depth, (2, h, w)).astype(ref_dt)
    dis = rng.integers(0, 1 << dis_depth, (2, h, w)).astype(dis_dt)
    prev0 = rng.integers(0, 1 << ref_depth, (h, w)).astype(ref_dt)
    got = kx.xpsnr_block_stats(
        *(torch.from_numpy(a) for a in (ref, dis, prev0)), dis_shift=ref_depth - dis_depth
    )
    assert all(g.shape == (2, -(-h // 16), -(-w // 16)) for g in got.values())
    dis_aligned = np.asarray(jax_engine._align_luma_depth(dis, dis_depth, ref_depth))
    want = _jnp_stats(ref, dis_aligned, np.concatenate([prev0[None], ref[:-1]]))
    _assert_grids({k: v.numpy() for k, v in got.items()}, want)


def test_weights_and_db_match_jax(rng):
    """The host scoring is the JAX package's, bit for bit, with and without
    the <= VGA smoothing."""
    grids = [rng.integers(0, 5000, (4, 5)).astype(np.uint32) for _ in range(3)]
    for width, height, depth in ((80, 64, 8), (1920, 1080, 10)):
        kw = dict(width=width, height=height, depth=depth)
        wsse_t, w_t = tx.xpsnr_weights(*(g.astype(np.int64) for g in grids), **kw)
        wsse_j, w_j = jx.xpsnr_weights(*grids, **kw)
        assert wsse_t == wsse_j
        np.testing.assert_array_equal(w_t, w_j)
        assert tx.xpsnr_db(wsse_t, **kw) == jx.xpsnr_db(wsse_j, **kw)
    assert tx.xpsnr_db(0.0, width=8, height=8) == float("inf")


def _engines(w, h, batch):
    """compute(y_ref, y_dis) -> XPSNR per frame, for the JAX engine and the
    port's (CPU), each keeping its own stream state."""
    uv = np.full(((h + 1) // 2, (w + 1) // 2, 2), 128, np.uint8)
    out = []
    for mod, frame, fallback in (
        (jax_engine, JaxRawFrame, jax_height_fallback), (port_engine, RawFrame, height_fallback)
    ):
        kw = {"device": "cpu"} if mod is port_engine else {}
        eng = mod.TurboMetrics(w, h, mod.Metrics(xpsnr=True), batch=batch, **kw)
        cc = (fallback(h), "limited")

        def compute(y_ref, y_dis, eng=eng, frame=frame, cc=cc):
            fr = [frame(y=y, uv=uv, depth=8) for y in y_ref]
            fd = [frame(y=y, uv=uv, depth=8) for y in y_dis]
            return [s.xpsnr for s in eng.compute_frames(fr, cc, fd, cc)]

        out.append((eng, compute))
    return out


@pytest.mark.parametrize("chunks", [[4], [2, 2], [3, 1]])
def test_engine_xpsnr_matches_jax(rng, chunks):
    """One batch of 4, or batches chained through the stream state (the last
    one padded), against the JAX engine and the oracle within 1e-9."""
    h, w = 48, 64
    ref = rng.integers(0, 256, (4, h, w), dtype=np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255).astype(np.uint8)
    (_, jax_compute), (_, port_compute) = _engines(w, h, max(chunks))
    got, want, at = [], [], 0
    for c in chunks:
        got += port_compute(list(ref[at : at + c]), list(dis[at : at + c]))
        want += jax_compute(list(ref[at : at + c]), list(dis[at : at + c]))
        at += c
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    prev = None
    for i in range(4):
        assert got[i] == pytest.approx(oracle.xpsnr_frame(ref[i], dis[i], prev)[1], abs=1e-9)
        prev = ref[i]


def test_reset_stream_state(rng):
    """After ``reset_stream_state`` a clip starts afresh: its first frame is
    its own previous frame, as in a new engine."""
    h, w = 32, 48
    ref = rng.integers(0, 256, (4, h, w), dtype=np.uint8)
    dis = rng.integers(0, 256, (4, h, w), dtype=np.uint8)
    (_, _), (eng, compute) = _engines(w, h, 2)
    first = compute(list(ref[:2]), list(dis[:2]))
    chained = compute(list(ref[2:]), list(dis[2:]))
    eng.reset_stream_state()
    fresh = compute(list(ref[2:]), list(dis[2:]))
    assert fresh[1] == chained[1] and fresh[0] != chained[0]
    eng.reset_stream_state()
    assert compute(list(ref[:2]), list(dis[:2])) == first


def test_identical_frames_inf():
    y = np.full((2, 32, 32), 128, np.uint8)
    (_, jax_compute), (_, port_compute) = _engines(32, 32, 2)
    assert all(np.isinf(s) for s in port_compute(list(y), list(y)))
    assert all(np.isinf(s) for s in jax_compute(list(y), list(y)))


def test_xpsnr_cli_matches_jax(tmp_path, rng, capsys):
    """``-m xpsnr`` through both CLIs: the same JSON keys and frame count,
    values within 1e-9, and the JAX CLI's CSV header."""
    w, h = 64, 48
    frames, dframes = [], []
    for _ in range(5):
        y = rng.integers(0, 256, (h, w), dtype=np.uint16)
        u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint16)
        v = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint16)
        frames.append((y, u, v))
        dframes.append((np.clip(y + rng.integers(-4, 5, y.shape), 0, 255), u, v))
    pr, pd = tmp_path / "r.y4m", tmp_path / "d.y4m"
    _write_y4m(pr, frames, w, h)
    _write_y4m(pd, dframes, w, h)
    args = [str(pr), str(pd), "-m", "xpsnr", "--output", "json", "--no-progress", "--batch", "2"]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"frame_count", "xpsnr"}
    assert set(got["xpsnr"]) == set(want["xpsnr"])
    assert got["frame_count"] == want["frame_count"] == 5
    np.testing.assert_allclose(got["xpsnr"]["scores"], want["xpsnr"]["scores"], rtol=0, atol=1e-9)
    assert port_cli.main(args[:4] + ["--output", "csv", "--no-progress", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "xpsnr"


def test_kernel_wrapper_on_cpu_counts_nothing_and_checks_inputs(rng):
    """On CPU tensors the wrapper runs its twin (no launch counted); shape,
    type, device and contiguity are checked before any launch."""
    ref, dis, _ = (torch.from_numpy(a) for a in _planes(rng, (2, 20, 24), 8))
    kx.xpsnr_block_stats.launches = 0
    kx.xpsnr_block_stats(ref, dis, ref[0])
    assert kx.xpsnr_block_stats.launches == 0
    bad = [
        (ref.float(), dis, ref[0].float()),  # type
        (ref, dis[:, :-1].contiguous(), ref[0]),  # shape
        (ref, dis, ref[0].to(torch.uint16)),  # prev type
        (ref.to("meta"), dis.to("meta"), ref[0].to("meta")),  # device
        (ref.transpose(-1, -2), dis.transpose(-1, -2), ref[0].T),  # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kx.xpsnr_block_stats(*args)


def _case_grids(rng, case: str) -> tuple:
    """(grids, width, height, depth) of a case of ``test_wsse_twin_matches_host_weighting``."""
    if case == "4K 10-bit":
        # Seeded grids of a 3840x2160 frame pair at 10 bits.
        shape, hi = (2, 135, 240), {"sse": 1 << 24, "sact": 1 << 22, "tact": 1 << 20}
        return {q: torch.from_numpy(rng.integers(0, hi[q], shape)) for q in kx.QUANTITIES}, 3840, 2160, 10
    h, w, ref_depth, dis_depth, b = {
        "1080p u8": (1080, 1920, 8, 8, 1),
        "10-bit over 8-bit": (496, 720, 10, 8, 2),
        "wrapped mod 2^32": (480, 656, 16, 16, 1),
        "zero SSE": (480, 656, 8, 8, 2),
    }[case]
    ref, dis, _ = _planes(rng, (b, h, w), ref_depth, wrap=case == "wrapped mod 2^32")
    if dis_depth != ref_depth:
        dis = rng.integers(0, 1 << dis_depth, dis.shape).astype(np.uint8)
    if case == "zero SSE":
        dis = ref
    ref, dis = torch.from_numpy(ref), torch.from_numpy(dis)
    return kx.xpsnr_block_stats(ref, dis, ref[0], dis_shift=ref_depth - dis_depth), w, h, ref_depth


@pytest.mark.parametrize("case", ["1080p u8", "4K 10-bit", "10-bit over 8-bit", "wrapped mod 2^32", "zero SSE"])
def test_wsse_twin_matches_host_weighting(rng, case):
    """Above 640x480 the twin of the card's weighted SSE, turned into dB on
    the host (``wsse_db``), gives ``xpsnr_weights`` + ``xpsnr_db`` within
    1e-9 dB: the sum itself within reordered f64 of the host's; the grids of
    #13's twin (a 10-bit reference over 8-bit distorted luma through
    ``dis_shift``, 16-bit SSEs past 2^32) or seeded ones (4K); a frame with
    no error is inf both ways."""
    grids, w, h, depth = _case_grids(rng, case)
    assert not tx.smoothed(w, h)
    kw = dict(width=w, height=h, depth=depth)
    wsse = kx.xpsnr_wsse(grids, depth=depth)
    assert wsse.dtype == torch.float64 and wsse.shape == grids["sse"].shape[:1]
    host = [float((tx.xpsnr_weights(*(grids[q][i].numpy() for q in kx.QUANTITIES), **kw)[1]
                   * grids["sse"][i].numpy().reshape(-1)).sum()) for i in range(wsse.shape[0])]
    np.testing.assert_allclose(wsse.numpy(), host, rtol=1e-13, atol=0)
    got, want = tx.wsse_db(wsse.numpy(), **kw), tx.frames_db(grids, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert all(np.isinf(got)) == (case == "zero SSE")


def test_wsse_wrapper_checks_its_grids():
    """The weighted SSE's wrapper takes three int64 (B, hb, wb) grids of one
    shape and device and a depth of 2-16 bits."""
    g = {q: torch.zeros((2, 3, 4), dtype=torch.int64) for q in kx.QUANTITIES}
    kx.xpsnr_wsse.launches = 0
    assert torch.equal(kx.xpsnr_wsse(g, depth=8), torch.zeros(2, dtype=torch.float64))
    assert kx.xpsnr_wsse.launches == 0
    bad = [
        ({**g, "sse": g["sse"].int()}, 8),  # type
        ({**g, "tact": g["tact"][:, :2]}, 8),  # shape
        ({k: v for k, v in g.items() if k != "sact"}, 8),  # a grid missing
        ({**g, "sact": g["sact"].to("meta")}, 8),  # device
        (g, 1),  # depth
        (g, 17),
    ]
    for grids, depth in bad:
        with pytest.raises(ValueError):
            kx.xpsnr_wsse(grids, depth=depth)


@pytest.mark.parametrize("w,h,path", [(640, 480, "host"), (641, 480, "card"), (64, 48, "host")])
def test_weighting_route_follows_frame_area(rng, w, h, path):
    """The engine weighs frames of at most 640x480 on the host from their
    grids and larger frames on the device, by area alone: the counters
    ``xpsnr.host_frames`` / ``xpsnr.card_frames`` count each batch's frames,
    and XPSNR is ``frames_db`` of the grids within 1e-9 dB."""
    b = 2
    eng = port_engine.TurboMetrics(w, h, port_engine.Metrics(xpsnr=True), batch=b, device="cpu")
    uv = np.full(((h + 1) // 2, (w + 1) // 2, 2), 128, np.uint8)
    ref = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255).astype(np.uint8)
    cc = (height_fallback(h), "limited")
    with port_engine.profiling.tracing():
        got = [s.xpsnr for s in eng.compute_frames([RawFrame(y=y, uv=uv) for y in ref], cc,
                                                   [RawFrame(y=y, uv=uv) for y in dis], cc)]
    counters = port_engine.profiling.take().counters
    assert counters[f"xpsnr.{path}_frames"] == b
    assert f"xpsnr.{'card' if path == 'host' else 'host'}_frames" not in counters
    r = torch.from_numpy(ref)
    want = tx.frames_db(kx.xpsnr_block_stats(r, torch.from_numpy(dis), r[0]), width=w, height=h)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
