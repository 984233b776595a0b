"""Every cell end to end on the CPU at a small size, through the port's
plain routes (the kernel wrappers run their twins on CPU tensors), and the
program fed from the ring against the engine fed from host frames."""

import json

import numpy as np

import pytest
from conftest import CPU_SIZE, REPO, SEED

from portbench import harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


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
    # On the CPU no device time is traced: the device's readers find nothing.
    cpu_silent = {"roofline_pct", "idle_pct", "device_p95_ms"}
    assert set(r["metrics"]) == {n for n in wanted if not (trace and n.split(".", 1)[0] in cpu_silent)}
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


@pytest.mark.parametrize("cell", CELLS)
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
