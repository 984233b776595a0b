"""Every cell end to end on the CPU at a small size, through the port's
plain routes (the kernel wrappers run their twins on CPU tensors), the
program fed from the ring against the engine fed from host frames, and the
host-fed program against the resident one."""

import inspect
import json

import numpy as np

import pytest
from conftest import CPU_SIZE, REPO, SEED

from portbench import harness
from turbo_metrics_tpu_torch.utils import profiling

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HOST = [c for c in CELLS if harness.load_cell(c)[0].get("feed") == "host"]
RESIDENT = [c for c in CELLS if c not in HOST]
# On the CPU no device time is traced: the device's readers find nothing.
CPU_SILENT = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}


def _run(cell, trace):
    import time

    return harness.run_cell(cell, SEED, 0.3, trace, t_start=time.perf_counter(), device="cpu", size=CPU_SIZE)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_result_line(cell, trace):
    r = _run(cell, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert json.loads(json.dumps(r)) == r
    spec = {m["name"]: m for m in BENCH["per_layer" if trace else "end_to_end"]}
    wanted = harness.cell_metrics(BENCH, cell, trace)
    assert set(r["metrics"]) == {n for n in wanted if not (trace and n in CPU_SILENT)}
    for name, m in r["metrics"].items():
        assert m["unit"] == spec[name]["unit"] and m["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    workload, config = harness.load_cell(cell)
    assert set(r["checks"]) == set(workload["limits"])


def _host_frames(cell, k):
    """Block ``k`` of the cell's ring as the engine's decoded host frames."""
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame

    planes = cell.ring.batch_planes(k)
    frames = {"ref": [], "dis": []}
    for side, fmt in (("ref", cell.workload["ref"]), ("dis", cell.workload["dis"])):
        own = planes.get(side) or tuple(p[0 if side == "ref" else 1] for p in planes["pair"])
        for j in range(cell.batch):
            if fmt["kind"] == "rgb":
                frames[side].append(RawFrame(rgb=own[0][j].numpy(), depth=fmt["depth"]))
            else:
                frames[side].append(RawFrame(y=own[0][j].numpy(), uv=own[1][j].numpy(), depth=fmt["depth"],
                                             full_range=fmt["range"] == "full", chroma=fmt["chroma"]))
    return frames["ref"], frames["dis"]


@pytest.mark.parametrize("cell", RESIDENT)
def test_the_program_is_the_engine(cell):
    """Three batches (the stream's start, its carry, the ring's next block)
    through the harness's resident engine and through the engine itself,
    fed the same planes as host frames: the same scores, bit for bit."""
    from turbo_metrics_tpu_torch.engine import TurboMetrics

    from portbench.program import ResidentEngine, engine_metrics

    c = harness.Cell(cell, SEED, "cpu", size=CPU_SIZE)
    assert type(c.program).__mro__[1] is TurboMetrics
    assert set(vars(ResidentEngine)) - set(vars(object)) <= {
        "__init__", "__module__", "__doc__", "__firstlineno__", "__static_attributes__", "attach", "run_block",
        "_planes", "_step", "_scores"}
    engine = TurboMetrics(c.width, c.height, engine_metrics(c.config), batch=c.batch, device="cpu")
    for k in (0, 1, 0):
        ref, dis = _host_frames(c, k)
        want = engine.compute_frames(ref, c.program.cc_ref, dis, c.program.cc_dis)
        got = c.program.run_block(k)
        assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
        assert got and all(np.isfinite(v) for s in got for v in s.to_dict().values())


@pytest.mark.parametrize("where", ["cpu", pytest.param("card", marks=pytest.mark.card)])
@pytest.mark.parametrize("cell", HOST)
def test_the_host_program_is_the_engine(cell, where, request):
    """The host-fed program is the engine with nothing replaced: its stack,
    upload, step and scoring are the engine's own.  Three batches through
    its ``compute_all`` with the prefetcher, across the ring's wrap, score
    as the resident program scores the same blocks, bit for bit: on the CPU
    at a small size, and on a card at the cell's own."""
    from turbo_metrics_tpu_torch.engine import TurboMetrics

    from portbench.program import ResidentEngine
    from portbench.program_host import HostEngine

    device, size = ("cpu", CPU_SIZE) if where == "cpu" else (request.getfixturevalue("card"), None)
    c = harness.Cell(cell, SEED, device, size=size)
    assert type(c.program) is HostEngine and HostEngine.__mro__[1] is TurboMetrics
    assert set(vars(HostEngine)) - set(vars(object)) <= {
        "__init__", "__module__", "__doc__", "__firstlineno__", "__static_attributes__", "attach", "stream",
        "compute_frames", "_planes", "_step", "_scores"}
    for name in ("compute_frames", "_planes", "_step", "_scores"):
        assert "super()" in inspect.getsource(getattr(HostEngine, name)), name
    resident = ResidentEngine(c.config, c.width, c.height, batch=c.batch, device=device)
    resident.attach(c.ring, c.workload)
    first = c.ring.blocks - 2
    got = c.program.stream(first, 3, float("inf"))
    want = [s for k in (first, first + 1, 0) for s in resident.run_block(k)]
    assert [t for t, _ in got] == list(range(first * c.batch, (first + 3) * c.batch))
    assert [s.to_dict() for _, s in got] == [s.to_dict() for s in want]
    assert got and all(np.isfinite(v) for _, s in got for v in s.to_dict().values())


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", ["all6_1080p8.yuv420"] + HOST)
def test_the_recorder_only_in_a_host_cells_traced_run(cell, trace, monkeypatch):
    """The engine's recorder is switched on once, across the untraced
    window, in a host-fed cell's traced run, and never in a resident
    cell's run or an untraced one."""
    switched = []
    tracing = profiling.tracing

    def spy(on=True):
        switched.append(on)
        return tracing(on)

    monkeypatch.setattr(profiling, "tracing", spy)
    profiling.take()
    r = _run(cell, trace)
    on = trace and cell in HOST
    assert switched == ([True] if on else [])
    assert not profiling.recording() and profiling.take().spans == {}
    assert ({"stack_ms", "h2d_ms", "wait_ms"} <= set(r["metrics"])) is on


@pytest.mark.parametrize("cell", ["all6_1080p8.yuv420"] + HOST)
def test_the_mmap_threshold_fixed_only_by_a_host_feed(cell, monkeypatch):
    """A host-fed cell's program fixes glibc's mmap threshold before it
    makes anything (program_host.fix_mmap_threshold, which glibc accepts
    here); a resident cell's never touches it."""
    from portbench import program_host

    program_host.fix_mmap_threshold()
    calls = []
    monkeypatch.setattr(program_host, "fix_mmap_threshold", lambda: calls.append(1))
    harness.Cell(cell, SEED, "cpu", size=CPU_SIZE)
    assert calls == ([1] if cell in HOST else [])
