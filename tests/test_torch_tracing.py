"""The program's spans and counters (utils/profiling.py) on the CPU: off they
cost a shared null context and record nothing; on they record nesting, self
time and per-thread stacks, mirror into torch.profiler's ranges, and the
engine, the prefetcher, the kernel library and the CLI record what their
readers take."""

import glob
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from turbo_metrics_tpu_torch import cli
from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    ColourPrimaries,
    MatrixCoefficients,
    TransferCharacteristic,
)
from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
from turbo_metrics_tpu_torch.io.frame_source import FrameSource, RawFrame
from turbo_metrics_tpu_torch.ops.kernels import _build
from turbo_metrics_tpu_torch.parallel.streaming import FramePrefetcher
from turbo_metrics_tpu_torch.utils import profiling

torch.set_num_threads(1)

CLIPS = Path(__file__).resolve().parents[1] / "turbo_metrics_tpu_torch" / "tools" / "clips"
CC = (ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.BT709), "limited")


@pytest.fixture(autouse=True)
def empty_records():
    """Every test starts and ends with the recording off and nothing kept."""
    assert not profiling.recording()
    profiling.take()
    yield
    profiling.take()


def test_off_span_is_one_shared_null_context(monkeypatch):
    """Off: every span is the same object, and neither it nor a count reads
    the clock, opens a profiler range or records anything; ``check`` counts
    no launch."""

    def forbidden(*args, **kwargs):
        raise AssertionError("called while the recording is off")

    monkeypatch.setattr(time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    a, b = profiling.span("tm.step"), profiling.span("tm.score")
    assert a is b
    with a:
        with b:
            profiling.count("upload_bytes", 10)
    _build.check(0, "tm_level_sums")
    records = profiling.take()
    assert records.spans == {} and records.counters == {}


def test_on_records_nesting_parent_and_self_time():
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    time.sleep(0.002)
                with profiling.span("inner"):
                    pass
                profiling.count("bytes", 3)
        _build.check(0, "tm_level_sums")
        _build.check(0, "tm_level_sums")
        _build.check(0, "tm_rgb_to_xyb")
    assert not profiling.recording()
    records = profiling.take()
    outer, inner = records.spans["outer"], records.spans["inner"]
    assert (outer.count, inner.count) == (2, 4)
    assert outer.parents == {None: 2} and inner.parents == {"outer": 4}
    assert inner.total_s >= 0.004 and inner.self_s == inner.total_s
    assert outer.total_s >= inner.total_s
    assert outer.self_s == pytest.approx(outer.total_s - inner.total_s, abs=1e-9)
    assert records.counters == {"bytes": 6, "launches.tm_level_sums": 2, "launches.tm_rgb_to_xyb": 1}
    assert records.per("outer") == 2 and records.per("missing") == 1
    assert profiling.take().spans == {}


def test_tracing_restores_the_state_before_it():
    with profiling.tracing():
        with profiling.tracing(False):
            assert profiling.span("x") is profiling.span("y")
        assert profiling.recording()
    assert not profiling.recording()


def test_each_thread_keeps_its_own_stack():
    """A span opened in another thread while the main thread holds one open
    has no parent: the prefetcher's decode never nests under the step."""
    opened, release = threading.Event(), threading.Event()

    def worker():
        opened.wait(5)
        with profiling.span("tm.decode"):
            pass
        release.set()

    with profiling.tracing():
        t = threading.Thread(target=worker)
        t.start()
        with profiling.span("tm.step"):
            opened.set()
            assert release.wait(5)
        t.join(5)
    assert not t.is_alive()
    records = profiling.take()
    assert records.spans["tm.decode"].parents == {None: 1}
    assert records.spans["tm.step"].parents == {None: 1}


def test_spans_are_profiler_ranges_that_nest_as_recorded():
    """Under torch.profiler on the CPU each span is a range of its name, the
    inner one inside the outer one, as the recorder has them."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        with profiling.span("tm.step"):
            with profiling.span("tm.step.quality"):
                torch.mm(a, a)
    events = {e.name: e for e in prof.events() if e.name.startswith("tm.")}
    assert set(events) == {"tm.step", "tm.step.quality"}
    outer, inner = events["tm.step"], events["tm.step.quality"]
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start <= inner.time_range.end <= outer.time_range.end
    assert profiling.take().spans["tm.step.quality"].parents == {"tm.step": 1}


def test_device_trace_names_the_step(tmp_path):
    """``device_trace`` switches the recording on for its block: the trace
    it writes holds the engine's ``tm.step`` range."""
    engine = TurboMetrics(32, 24, Metrics(psnr=True), batch=1, device="cpu")
    ref, dis = _yuv_frames(np.random.default_rng(0), 1, 32, 24)
    with profiling.device_trace(str(tmp_path)) as log_dir:
        engine.compute_frames(ref, CC, dis, CC)
    assert not profiling.recording()
    (path,) = glob.glob(os.path.join(log_dir, "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tm.batch", "tm.step", "tm.score"} <= names


def _yuv_frames(rng, n: int, w: int, h: int):
    def frame(y):
        uv = rng.integers(16, 241, ((h + 1) // 2, (w + 1) // 2, 2), dtype=np.uint8)
        return RawFrame(y=y, uv=uv)

    ref = [rng.integers(16, 236, (h, w), dtype=np.uint8) for _ in range(n)]
    dis = [np.clip(y.astype(int) + rng.integers(-4, 5, y.shape), 0, 255).astype(np.uint8) for y in ref]
    return [frame(y) for y in ref], [frame(y) for y in dis]


def _leaf_bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(_leaf_bytes(v) for v in values)


def test_all_six_engine_records_each_family_once_a_batch(monkeypatch):
    """An all-six engine on small frames: per batch one ``tm.batch``, one
    ``tm.step`` and one ``tm.score``, each family's step and scoring span
    once, the planes stacked and uploaded per field; ``upload_bytes`` the
    planes' bytes and ``readback_bytes`` the step's results' bytes."""
    w, h, b, batches = 48, 32, 2, 2
    metrics = Metrics(psnr=True, ssim=True, msssim=True, ssimulacra2=True, xpsnr=True, vmaf=True)
    engine = TurboMetrics(w, h, metrics, batch=b, device="cpu")
    results = []
    scores = engine._scores
    monkeypatch.setattr(engine, "_scores", lambda out, *a: (results.append(out), scores(out, *a))[1])
    rng = np.random.default_rng(3)
    uploaded = 0
    with profiling.tracing():
        for _ in range(batches):
            ref, dis = _yuv_frames(rng, b, w, h)
            uploaded += sum(f.y.nbytes + f.uv.nbytes for f in ref + dis)
            engine.compute_frames(ref, CC, dis, CC)
    records = profiling.take()
    once = ["tm.batch", "tm.step", "tm.planes", "tm.step.convert", "tm.step.quality", "tm.step.ssimulacra2",
            "tm.step.ssimulacra2.levels", "tm.step.ssimulacra2.norms", "tm.step.xpsnr", "tm.step.vmaf",
            "tm.score", "tm.wait", "tm.score.quality", "tm.score.ssimulacra2", "tm.score.xpsnr", "tm.score.vmaf"]
    assert {name: records.spans[name].count for name in once} == dict.fromkeys(once, batches)
    assert records.per() == batches
    # Planar YUV of one spec: the pair stacked once per field (luma, chroma).
    assert records.spans["tm.planes.stack"].count == records.spans["tm.planes.upload"].count == 2 * batches
    assert records.spans["tm.planes.upload"].parents == {"tm.planes": 2 * batches}
    assert records.spans["tm.step"].parents == {"tm.batch": batches}
    assert records.spans["tm.step.ssimulacra2.levels"].parents == {"tm.step.ssimulacra2": batches}
    assert records.counters["upload_bytes"] == uploaded
    assert records.counters["readback_bytes"] == sum(_leaf_bytes(out) for out in results)
    assert records.spans["tm.readback"].count == sum(len(list(_leaves(out))) for out in results)
    assert set(records.spans["tm.readback"].parents) == {
        "tm.score.quality", "tm.score.ssimulacra2", "tm.score.xpsnr", "tm.score.vmaf"}
    # The plain routes on the CPU launch nothing of the kernel library.
    assert not any(name.startswith("launches.") for name in records.counters)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


class _ListSource(FrameSource):
    """8x8 frames from a list, then None."""

    width = height = 8

    def __init__(self, frames):
        self.frames = list(frames)

    def next_frame(self):
        return self.frames.pop(0) if self.frames else None

    def color_characteristics(self):
        return CC

    def format_id(self):
        return "list"

    def frame_count(self):
        return len(self.frames)


def test_prefetcher_records_decode_and_wait():
    """The prefetcher's thread records one ``tm.decode`` per batch on a
    stack of its own; the consumer's waits on its queue are
    ``tm.prefetch.wait``, the end of the stream's included."""
    frames = [RawFrame(y=np.full((8, 8), i, np.uint8), uv=np.zeros((4, 4, 2), np.uint8)) for i in range(7)]
    with profiling.tracing():
        with profiling.span("tm.consumer"):
            batches = list(FramePrefetcher(_ListSource(frames), _ListSource(frames), batch=3))
    assert [len(r) for r, _ in batches] == [3, 3, 1]
    assert [f.y[0, 0] for r, _ in batches for f in r] == list(range(7))
    records = profiling.take()
    assert records.spans["tm.decode"].count == 3
    assert records.spans["tm.decode"].parents == {None: 3}
    assert records.spans["tm.prefetch.wait"].count == 4
    assert records.spans["tm.prefetch.wait"].parents == {"tm.consumer": 4}


def test_library_load_and_build_are_recorded(monkeypatch, tmp_path):
    """``tm.library.load`` spans the library's first load, and a build
    counts once as ``library_builds``."""
    lib = _build.KernelLibrary()
    monkeypatch.setattr(_build.KernelLibrary, "_path", staticmethod(lambda: tmp_path / "libtm.so"))

    def no_nvcc():
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with profiling.tracing(), pytest.raises(RuntimeError, match="no nvcc here"):
        lib.get()
    records = profiling.take()
    assert records.spans["tm.library.load"].count == 1
    assert records.counters == {"library_builds": 1}


def test_cli_trace_prints_spans_and_counters(tmp_path, capsys):
    """``--trace DIR`` on the committed clips: a trace in DIR, and on
    stderr each span's count and ms a batch and the counters, decode,
    prefetch, stack and upload among them; the scores are the untraced
    run's."""
    args = [str(CLIPS / "ref_vp9.mkv"), str(CLIPS / "dis_mpeg2.ts"), "-m", "psnr", "--frames", "2", "--batch", "2",
            "--device", "cpu", "--output", "json", "--no-progress"]
    assert cli.main(args) == 0
    plain = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--trace", str(tmp_path)]) == 0
    captured = capsys.readouterr()
    assert json.loads(captured.out) == plain
    assert glob.glob(str(tmp_path / "trace_*.json"))
    lines = {line.split()[0]: line.split()[1:] for line in captured.err.splitlines() if line.startswith("  ")}
    for name in ("tm.batch", "tm.step", "tm.planes.stack", "tm.planes.upload", "tm.decode", "tm.prefetch.wait",
                 "tm.score", "tm.readback"):
        assert name in lines, captured.err
    assert lines["tm.batch"][0] == "1"
    # One batch of two 1080p 4:2:0 pairs, both inputs stacked: 2 x 2 x 1.5 bytes a pixel.
    assert lines["upload_bytes"][0] == str(2 * 2 * 1920 * 1080 * 3 // 2)
    assert "spans over 1 batch(es)" in captured.err
    assert not profiling.recording()
