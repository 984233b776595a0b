"""All six metrics on 10-bit 4:2:0 pairs through the port's engine, with the
SSIMULACRA2 level chain routed as at 3840x2160 (#3 on the first levels, #4
on the rest), against the benchmark's plain float64 reference within the
limits of its 4K cell; the route's spans and counters.

At 160x90 kernel 2's gate stays off (level 1 is 45 rows high) and the
pyramid has five scales; TAIL_MAX_BYTES is lowered to level 3's plane so
that #4 starts where it starts at 4K.  A six-scale frame with kernel 2 off
is at least 113x2049, too slow for the CPU suite: the six-level chain is
run directly.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.program import colour
from portbench.reference.scores import FAMILY_KEYS
from portbench.traffic import make_ring
from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.models import ssimulacra2 as s2
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.utils import profiling

torch.set_num_threads(1)

CELL = Path(__file__).resolve().parents[1] / "portbench" / "workloads" / "all6_2160p10.yuv420.json"
ALL6 = ["psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf"]
W, H, BATCH = 160, 90, 4
SEED = 2**31 + 27
SCALE, TAIL, PYRAMID = (s2.ROUTE_RECORDS[k] for k in ("fused_scale_rgb", "fused_tail", "fused_pyramid_tail"))


@pytest.fixture(autouse=True)
def empty_records():
    assert not profiling.recording()
    profiling.take()
    yield
    profiling.take()


def _tail_from_level_3(monkeypatch, h, w):
    """Lower TAIL_MAX_BYTES to level 3's plane of an h x w frame: #3 takes
    levels 0-2 and #4 the rest, as at 3840x2160."""
    dims = scale_dims(h, w)
    monkeypatch.setattr(s2, "TAIL_MAX_BYTES", s2.tail_plane_bytes(*dims[3]))
    assert s2.tail_plane_bytes(*dims[2]) > s2.TAIL_MAX_BYTES


@pytest.mark.parametrize("first_level", [0, 1])
def test_level_route_at_2160p(first_level):
    """3840x2160: #3 on levels 0, 1 and 2, then #4 on 3-5 (from level 1,
    after kernel 1 or #3 on level 0, the same from level 1 on)."""
    h, w = scale_dims(2160, 3840)[first_level]
    want = [("fused_scale_rgb", (s,)) for s in range(first_level, 3)] + [("fused_tail", (3, 4, 5))]
    assert s2.level_route(h, w, 6, first_level) == want
    assert not s2.tail2_engages(5, *scale_dims(2160, 3840)[1])


def _pair(h, w):
    gen = torch.Generator().manual_seed(SEED)
    return torch.rand((2, 2, 3, h, w), generator=gen, dtype=torch.float32)


@pytest.mark.parametrize("h,w,first_level,patched,want", [
    # 160x90 with #4 from level 3, six levels: the 4K chain's shape.
    (90, 160, 0, True, {SCALE[1]: 3, TAIL[1]: 3}),
    # A 1080p-like level 1: kernel 2 takes the five remaining levels.
    (96, 128, 1, False, {PYRAMID[1]: 5}),
])
def test_chain_records_each_route_step(monkeypatch, h, w, first_level, patched, want):
    """Each kernel the route runs is one span, and its counter adds the
    levels it took; off, the chain records nothing and gives the same sums."""
    if patched:
        _tail_from_level_3(monkeypatch, h, w)
    taps, opsin = s2._level_consts(None, None, torch.device("cpu"))
    p12 = _pair(h, w)
    route = s2.level_route(h, w, 6, first_level)
    off = s2.level_sums_chain(p12, first_level, taps, opsin, num_scales=6)
    assert profiling.take().counters == {}
    with profiling.tracing():
        on = s2.level_sums_chain(p12, first_level, taps, opsin, num_scales=6)
    records = profiling.take()
    assert records.counters == want
    assert sum(want.values()) == len(on) == 6 - first_level
    spans = {name: stats.count for name, stats in records.spans.items()}
    assert spans == {s2.ROUTE_RECORDS[k][0]: sum(1 for kk, _ in route if kk == k) for k, _ in route}
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _host_frames(ring, k):
    """Block ``k`` of the ring as the engine's decoded 10-bit host frames."""
    luma, chroma = ring.batch_planes(k)["pair"]
    return [[RawFrame(y=luma[side, j].numpy(), uv=chroma[side, j].numpy(), depth=10, chroma=420)
             for j in range(ring.batch)] for side in (0, 1)]


def test_engine_all6_10bit_matches_reference(monkeypatch):
    """Two batches of four 10-bit 4:2:0 pairs (XPSNR's and motion's state
    crossing the boundary) through ``compute_frames``: every family within
    the 4K cell's limit of the float64 reference, the level route recorded
    as #3 on levels 0-2 and #4 on the rest in each batch."""
    _tail_from_level_3(monkeypatch, H, W)
    workload = json.loads(CELL.read_text())
    assert workload["ref"] == workload["dis"] and workload["ref"]["depth"] == 10
    ring = make_ring(dict(workload, ring=2 * BATCH), W, H, BATCH, SEED, "cpu")
    engine = TurboMetrics(W, H, Metrics(**{m: True for m in ALL6}), batch=BATCH, device="cpu")
    cc = colour(workload["ref"])
    answers, buffers = [], []
    with profiling.tracing():
        for k in range(ring.blocks):
            ref, dis = _host_frames(ring, k)
            answers += [(k * BATCH + j, s.to_dict()) for j, s in enumerate(engine.compute_frames(ref, cc, dis, cc))]
            buffers.append(engine._results_host.data_ptr())
    records = profiling.take()
    # Each batch's results, XPSNR's three grids among them at this size, are
    # read in one copy into one host buffer, kept from batch to batch.
    assert buffers[0] == buffers[1] and records.spans["tm.readback"].count == ring.blocks
    assert records.counters["readback_bytes"] == ring.blocks * engine._results_host.numel()
    assert records.counters["xpsnr.host_frames"] == ring.blocks * BATCH and "xpsnr.card_frames" not in records.counters
    ns = engine.model.num_scales
    assert records.counters["levels.scale"] == 3 * ring.blocks
    assert records.counters["levels.tail"] == (ns - 3) * ring.blocks
    assert "levels.pyramid" not in records.counters
    assert records.spans[SCALE[0]].parents == {"tm.step.ssimulacra2.levels": 3 * ring.blocks}
    assert records.spans[TAIL[0]].count == ring.blocks

    program = check.program_values(answers)
    reference = check.reference_values(ring, [t for t, _ in answers], ALL6)
    found = check.gaps(program, reference, ALL6)
    assert set(found) == set(workload["limits"])
    ok, checks = check.judge(found, workload["limits"])
    assert ok, checks
    for fam in found:
        for key in FAMILY_KEYS[fam]:
            assert np.all(np.isfinite(program[key])), key


def test_to_host_into_a_kept_buffer():
    """``to_host(t, out=buf)`` copies into ``buf`` and returns its view,
    recorded as a readback of ``t``'s bytes."""
    t = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    buf = torch.empty((2, 3, 4), dtype=torch.int64)
    with profiling.tracing():
        a = profiling.to_host(t * 2, out=buf[1])
    records = profiling.take()
    np.testing.assert_array_equal(a, (t * 2).numpy())
    a[0, 0] = -1
    assert buf[1, 0, 0] == -1
    assert records.counters == {"readback_bytes": 96} and records.spans["tm.readback"].count == 1
