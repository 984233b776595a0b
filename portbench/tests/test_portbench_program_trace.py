"""The program's ``tm.`` ranges in a trace (program_trace.py): their device
mirrors never count as device operations, idle gaps take the innermost
span, the program's or the harness's, and a run of the benchmark as it
stands leaves the program's recording off."""

import json

import pytest
from conftest import CPU_SIZE, SEED
from torch.autograd import DeviceType

from portbench import harness, trace
from portbench.program_trace import OUTSIDE_PROGRAM, ProgramTrace
from turbo_metrics_tpu_torch.utils import profiling


class Event:
    """A profiler record as ``Trace.from_events`` reads it."""

    def __init__(self, name, start, end, cuda=False):
        self._name, self._start, self._end, self._cuda = name, start, end, cuda

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


# One batch: the step from 0 to 50 ns, its SSIMULACRA2 levels launched from 10
# to 30, two kernels, the scoring from 60; each range mirrored on the device
# over the kernels it launched.
HARNESS = [Event("pb.batch", 0, 100), Event("pb.launch", 0, 50), Event("pb.wait", 50, 60),
           Event("pb.score", 60, 100), Event("pb.launch", 20, 45, cuda=True)]
KERNELS = [Event("level_tile_kernel", 20, 40, cuda=True), Event("yuv420_to_xyb_kernel", 42, 45, cuda=True),
           Event("Memcpy DtoH (Device -> Pageable)", 70, 80, cuda=True)]
PROGRAM = [Event("tm.batch", 0, 100), Event("tm.step", 5, 48), Event("tm.step.ssimulacra2", 8, 46),
           Event("tm.step.ssimulacra2.levels", 10, 30), Event("tm.score", 61, 99), Event("tm.readback", 65, 85),
           Event("tm.step", 20, 45, cuda=True), Event("tm.step.ssimulacra2", 20, 45, cuda=True),
           Event("tm.step.ssimulacra2.levels", 20, 40, cuda=True), Event("tm.readback", 70, 80, cuda=True)]


def test_mirrors_stay_out_of_the_device_records():
    """The device's readings with the program's ranges equal those without
    them; read as ``Trace`` reads them, the mirrors would be busy time."""
    mine = ProgramTrace.from_events(HARNESS + KERNELS + PROGRAM)
    before = trace.Trace.from_events(HARNESS + KERNELS)
    assert mine.device == before.device
    assert mine.spans == before.spans
    assert (mine.busy_s(), mine.batch_device_s(), mine.device_ops()) == (
        before.busy_s(), before.batch_device_s(), before.device_ops())
    assert set(mine.program) == {"tm.batch", "tm.step", "tm.step.ssimulacra2", "tm.step.ssimulacra2.levels",
                                 "tm.score", "tm.readback"}
    assert len(mine.mirrors) == 4
    naive = trace.Trace.from_events(HARNESS + KERNELS + PROGRAM)
    assert any(name.startswith("tm.") for name, _, _ in naive.device)


def test_idle_gaps_take_the_innermost_span():
    """A gap takes the innermost span around its middle, the program's or
    the harness's; without the program's ranges the labels are Trace's."""
    mine = ProgramTrace.from_events(HARNESS + KERNELS + PROGRAM)
    # Gaps: [0, 20) middle 10, [40, 42) 41, [45, 70) 57, [80, 100) 90.
    assert dict(mine.idle_gaps()) == pytest.approx({
        "tm.step.ssimulacra2.levels": 20e-9, "tm.step.ssimulacra2": 2e-9, "pb.wait": 25e-9, "tm.score": 20e-9})
    assert mine.labelled_share("pb.launch") == (pytest.approx(22e-9), 1.0)
    assert mine.labelled_share("pb.wait") == (pytest.approx(25e-9), 0.0)
    without = ProgramTrace.from_events(HARNESS + KERNELS)
    assert without.idle_gaps() == trace.Trace.from_events(HARNESS + KERNELS).idle_gaps()
    assert dict(without.idle_gaps()) == pytest.approx({"pb.launch": 22e-9, "pb.wait": 25e-9, "pb.score": 20e-9})


def test_device_families_by_the_innermost_mirror():
    mine = ProgramTrace.from_events(HARNESS + KERNELS + PROGRAM)
    assert dict(mine.device_families()) == pytest.approx({
        "tm.step.ssimulacra2.levels": 20e-9, "tm.step.ssimulacra2": 3e-9, "tm.readback": 10e-9})
    bare = ProgramTrace.from_events(HARNESS + KERNELS)
    assert dict(bare.device_families()) == pytest.approx({OUTSIDE_PROGRAM: 33e-9})


@pytest.fixture(scope="module")
def cell():
    """The all-six cell on the CPU, past its warm batches."""
    cell = harness.Cell("all6_1080p8.yuv420", SEED, "cpu", size=CPU_SIZE)
    for _ in range(harness.WARM_BATCHES):
        cell.batch_scores()
    return cell


def test_the_benchmark_leaves_the_program_silent(cell, monkeypatch):
    """A traced window of the benchmark as it stands: the program records
    nothing and no ``tm.`` range reaches the profiler, so every device
    reading is taken from the same records as before."""
    names = set()
    from_events = trace.Trace.from_events.__func__

    def spy(cls, events):
        events = list(events)
        names.update(e.name() for e in events)
        return from_events(cls, events)

    monkeypatch.setattr(trace.Trace, "from_events", classmethod(spy))
    cell.traced_window(0.2)
    assert "pb.batch" in names and not any(n.startswith("tm.") for n in names)
    assert profiling.take().spans == {}


def test_a_recording_program_nests_in_the_harness_spans(cell, monkeypatch):
    """With the program's recording on, the profiler's records of a CPU
    window hold one ``tm.batch``, ``tm.step`` and ``tm.score`` per batch,
    ``tm.step`` inside ``pb.launch`` and ``tm.score`` inside ``pb.score``;
    with no device records the window is one idle gap."""
    monkeypatch.setattr(trace, "Trace", ProgramTrace)
    with profiling.tracing():
        _, tr = cell.traced_window(0.2)
    records = profiling.take()
    batches = len(tr.spans["pb.batch"])
    assert batches > 0
    for name in ("tm.batch", "tm.step", "tm.score", "tm.step.vmaf", "tm.score.vmaf"):
        assert len(tr.program[name]) == records.spans[name].count == batches, name
    for inner, outer in (("tm.step", "pb.launch"), ("tm.score", "pb.score")):
        for (a, b), (c, d) in zip(tr.program[inner], tr.spans[outer]):
            assert c <= a <= b <= d
    assert sum(s for _, s in tr.idle_gaps()) == pytest.approx(tr.window_s())


def test_span_account_on_the_cpu(tmp_path):
    """The account tool rehearsed on the CPU: both ways' medians, the
    program's readings beside the harness's, every idle second inside
    ``pb.launch`` under a ``tm.`` span."""
    from portbench import span_account

    out = tmp_path / "account.json"
    assert span_account.main(["--cells", "s2_1080p8.yuv420", "--device", "cpu", "--size", *map(str, CPU_SIZE),
                              "--seconds", "0.3", "--turns", "1", "--traced", "0.3", "--out", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    off, on = r["medians"]["off"], r["medians"]["on"]
    assert off["fps"] > 0 and "step_ms" not in off
    assert on["step_ms"] == pytest.approx(on["launch_ms"], rel=0.1)
    assert on["scoring_ms"] == pytest.approx(on["score_ms"], rel=0.5)
    assert on["library_calls"] == 0.0
    traced_on = r["traced"][1]
    assert traced_on["launch_idle_tm_share"] == 1.0
    assert r["traced"][0]["idle_gaps"][0][0].startswith("pb.")
