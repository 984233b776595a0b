"""Kernel #4's readers: ``tail_roofline_pct``'s work of SSIMULACRA2's levels
3-5 counted by hand at 3840x2160, and ``tail_ms`` / ``tail_roofline_pct``
on a fabricated trace, None where no ``fused_tail_kernel`` ran."""

import json

import pytest
from conftest import REPO

from portbench import harness, roofline
from portbench.harness import Run
from portbench.metrics import tail_roofline_pct
from portbench.trace import Trace

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_levels_3_to_5_by_hand():
    # Levels 3, 4, 5 of 3840x2160: 270x480, 135x240, 68x120.  Per pixel XYB
    # of both images 78, the 2x2 mean 24 on levels 4 and 5 (level 3 comes
    # in made).  Per channel (X, Y, B) the maps the nonzero weights need: the
    # SSIM map 143, with the edge maps 7 + 5 per map:
    #   level 3: X ssim+art 155, Y all three 160, B ssim+art 155;
    #   level 4: X all 160, Y ssim+art 155, B all 160;
    #   level 5: X ssim 143, Y none 0, B ssim+det 155.
    assert (roofline.S2_XYB, roofline.S2_HALF, roofline.S2_SSIM) == (78, 24, 143)
    ops = (78 + 155 + 160 + 155) * 270 * 480 + (78 + 24 + 160 + 155 + 160) * 135 * 240 \
        + (78 + 24 + 143 + 0 + 155) * 68 * 120
    assert tail_roofline_pct.tail_ops(2160, 3840) == ops == 92_979_600
    wk = tail_roofline_pct.tail_work(2160, 3840, 4)
    # Level 3's f32 pair read once, three levels of (3, 6) f32 sums written.
    assert wk.int_ops == 0 and wk.f32_ops == 4 * ops
    assert wk.bytes == 4 * (2 * 3 * 270 * 480 * 4 + 3 * 3 * 6 * 4)
    assert wk.least_seconds() == pytest.approx(4 * ops / 67e12)


@pytest.mark.parametrize("hw", [(2160, 3840), (1080, 1920), (96, 160)])
def test_from_level_0_is_the_roofline_count(hw):
    assert tail_roofline_pct.tail_ops(*hw, first=0) == roofline.ssimulacra2_ops(*hw)


def test_frame_is_the_listed_cells():
    cells = next(m for m in BENCH["per_layer"] if m["name"] == "tail_roofline_pct.all6")["workloads"]
    for cell in cells:
        config = harness.load_cell(cell)[1]
        assert (config["height"], config["width"]) == tail_roofline_pct.FRAME


def _run(device):
    # Two traced batches of 10 us each; the untraced window ran 3 batches
    # of 4 frames.
    trace = Trace(spans={"pb.batch": [(0, 10_000), (10_000, 20_000)], "pb.launch": [], "pb.wait": [],
                         "pb.score": []}, device=device)
    return Run(setup_s=1.0, window_s=1.0, frames=12, latencies_s=[0.1] * 3, spans_s={},
               work=roofline.Work(), trace=trace)


def test_readers_on_a_fabricated_trace():
    run = _run([("level_tile_kernel", 100, 2_000), ("fused_tail_kernel", 2_000, 4_000),
                ("fused_tail_kernel", 12_000, 15_000), ("reduce_parts_kernel<6>", 15_000, 16_000)])
    assert harness.reader("tail_ms.all6")(run) == pytest.approx(5_000e-9 * 1e3 / 2)
    want = 100.0 * 2 * tail_roofline_pct.tail_work(2160, 3840, 4).least_seconds() / 5_000e-9
    assert harness.reader("tail_roofline_pct.all6")(run) == pytest.approx(want)


@pytest.mark.parametrize("device", [[], [("level_tile_kernel", 100, 2_000)]], ids=["idle", "no_tail"])
def test_readers_none_without_the_tail_kernel(device):
    for name in ("tail_ms.all6", "tail_roofline_pct.all6"):
        assert harness.reader(name)(_run(device)) is None
        assert harness.reader(name)(Run(1.0, 1.0, 12, [0.1] * 3, {}, roofline.Work())) is None
