"""The port's profiling helpers (utils/profiling.py) on the CPU: the timer,
the trace, and the dissect tool's use of them."""

import glob
import json
import os

import pytest
import torch

from turbo_metrics_tpu_torch.tools import kernel_dissect, psnr_timing
from turbo_metrics_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_timer_measure_appends_seconds():
    """``measure`` appends one sample per block, in seconds, and syncs the
    devices of the result it is given: a tensor, a nest of them, or a list
    the block fills."""
    t = profiling.Timer()
    a = torch.ones(64, 64)
    with t.measure(a):
        a = a @ a
    out = []
    with t.measure(out):
        out.append({"x": (a + 1,)})
    with t.measure():
        pass
    assert len(t.samples) == 3
    assert all(isinstance(s, float) and 0.0 <= s < 10.0 for s in t.samples)


def test_timer_time_fn_on_the_cpu():
    """``time_fn``: the host clock for a result on the CPU, warm-up calls not
    timed; seconds per call, appended to ``samples``."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = profiling.Timer()
    dt = t.time_fn(fn, torch.ones(8), iters=5, warmup=2)
    assert len(calls) == 7
    assert t.samples == [dt] and 0.0 <= dt < 1.0


def test_device_trace_writes_a_trace_naming_the_op(tmp_path):
    """``device_trace`` yields its directory and leaves a Chrome/Perfetto
    trace there that names the op run inside it."""
    a = torch.ones(32, 32)
    with profiling.device_trace(str(tmp_path / "trace")) as log_dir:
        torch.mm(a, a)
    assert log_dir == str(tmp_path / "trace")
    files = glob.glob(os.path.join(log_dir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_trace_default_directory(tmp_path, monkeypatch):
    """Without a directory the trace goes to the temporary directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.device_trace() as log_dir:
        torch.ones(4).sum()
    assert log_dir == os.path.join(str(tmp_path), "turbo_metrics_trace")
    assert glob.glob(os.path.join(log_dir, "trace_*.json"))


def test_time_ms_on_the_cpu():
    n = []
    ms = profiling.time_ms(lambda: n.append(1), 4, torch.device("cpu"), warmup=1)
    assert len(n) == 5 and ms >= 0.0


def test_dissect_tool_uses_profiling():
    """The dissect tool's timer and profiler reading are profiling's, not
    copies."""
    assert kernel_dissect.time_ms is profiling.time_ms
    assert kernel_dissect.cuda_kernel_records is profiling.cuda_kernel_records
    assert kernel_dissect.kernel_name is profiling.kernel_name
    assert kernel_dissect.MEMSET == profiling.MEMSET


@pytest.mark.parametrize("tree", [torch.ones(2), [torch.ones(2)], {"a": (torch.ones(1), None)}, None, 3])
def test_synchronize_takes_any_nest(tree):
    """A nest of CPU tensors (or no tensor at all) needs no device sync."""
    assert profiling._cuda_devices(tree) == set()
    profiling.synchronize(tree)


@pytest.mark.parametrize("shape", [(2, 48, 64), (3, 67, 99)], ids=["48x64", "67x99"])
def test_psnr_timing_tool_on_the_cpu(shape, capsys):
    """The PSNR timing tool on the CPU: the exact formulations (quality.psnr
    among them) agree bit for bit on a batch and on each half of it, and
    every formulation gets one time per timed run."""
    b, h, w = shape
    out = psnr_timing.main(["--device", "cpu", "--batch", str(b), "--height", str(h), "--width", str(w),
                            "--iters", "1", "--rounds", "1"])
    assert [r["name"] for r in out["psnr_timing"]] == list(psnr_timing.FORMULATIONS)
    assert all(len(r["ms"]) == 2 and min(r["ms"]) > 0 for r in out["psnr_timing"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
