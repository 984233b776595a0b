"""Run one cell of the benchmark once.

A cell is found by its name alone: ``workloads/<name>.json`` holds its
traffic (the two inputs' pixel formats, the ring, the batch, the content,
the sample checked and the limits of the check), its ``config`` names
``configs/<config>.json`` (the frame size and the metrics, which the
engine's constructor takes), and every metric that ``BENCHMARK.json`` lists
for the cell is read by ``metrics/<metric>.py``.  A later cell,
configuration or metric is a new file; nothing here changes.

One run: set-up (the program's import, the device, the engine and its
models, the ring made on the device from the seed, two warm batches, which
load the kernel library, or build it on a checkout's first run, and start
the stream), then the window: batches from the ring through the engine's
``compute_frames``, one after another on one stream, each handed over once
the last one's per-frame scores are Python floats on the host, until
``seconds`` have passed.  The workload's ``feed`` picks the program
(``FEEDS``): the ring's planes handed to the engine's step on the card
(program.py, the default), or host frames through the engine's own
``compute_all``, stack, upload and prefetcher (program_host.py), whose
traced runs also record the engine's own spans over the untraced window
(``Run.records``).  The harness's spans (trace.py) time each batch and its
phases on the host clock.  With ``trace`` a second window of at most
``TRACE_SECONDS`` follows under the profiler.  After the windows: the peak
of device memory, the program's state freed, the check against the
reference, and the guard that neither JAX nor the JAX package was loaded.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import check, roofline
from portbench.program import ResidentEngine
from portbench.program_host import HostEngine
from portbench.trace import Spans, recording
from portbench.traffic import make_ring
from turbo_metrics_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent
# Top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "turbo_metrics_tpu")
WARM_BATCHES = 2
# A traced run's second window lasts at most this long: the trace's
# reduction grows with the events recorded, and a run ends within 360 s.
TRACE_SECONDS = 3.0
# A workload's "feed" ("resident" where it names none): its program, and
# whether a ``--trace 1`` run records the engine's own spans and counters
# (utils/profiling.py) across its untraced window.
FEEDS = {"resident": (ResidentEngine, False), "host": (HostEngine, True)}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root.parent / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict]:
    """(workload, config) of the cell ``name``, from their files."""
    workload = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{workload['config']}.json")
    return workload, config


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[str]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, each where it names the cell or names no
    cells."""
    return [m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``, or, for a name
    ``<base>.<group>`` (one quantity under a bound of its own for a group of
    cells) without a file of its own, of ``metrics/<base>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        path = root / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read: the host clock's readings of the
    window (``spans_s``: each span's seconds, trace.SPANS), the least work
    of a batch, with ``--trace 1`` the trace of the second window, and in a
    feed that records them the engine's spans and counters of the untraced
    window (``records``, utils/profiling.Records)."""

    setup_s: float
    window_s: float
    frames: int
    latencies_s: list
    spans_s: dict
    work: roofline.Work
    trace: object = None
    records: object = None


class Cell:
    """One cell's program and inputs, ready to run."""

    def __init__(self, name: str, seed: int, device, *, root: Path = ROOT, size=None):
        self.name, self.seed = name, int(seed)
        self.workload, self.config = load_cell(name, root)
        self.device = torch.device(device)
        self.width, self.height = size or (self.config["width"], self.config["height"])
        b = self.workload["batch"]
        self.feed = self.workload.get("feed", "resident")
        program, self.records_spans = FEEDS[self.feed]
        self.program = program(self.config, self.width, self.height,
                               batch=None if b == "default" else int(b), device=self.device)
        self.batch = self.program.batch
        self.ring = make_ring(self.workload, self.width, self.height, self.batch, self.seed, self.device)
        self.program.attach(self.ring, self.workload)
        self.spans = self.program.spans = Spans()
        self.next_block = 0
        self.work = roofline.batch_work(self.config["metrics"], self.workload["ref"], self.workload["dis"],
                                        self.height, self.width, self.batch)

    def batch_scores(self) -> list:
        """Run the next batch of the ring through the program: its frames'
        scores (``FrameScores``)."""
        if self.feed == "host":
            return [s for _, s in self._host_blocks(1, float("inf"))]
        with self.spans("pb.batch"):
            scores = self.program.run_block(self.next_block % self.ring.blocks)
        self.next_block += 1
        return scores

    def window(self, seconds: float, max_batches: int | None = None):
        """Batches until ``seconds`` have passed (or ``max_batches`` ran):
        (window seconds, per-batch latencies, answers)."""
        if self.feed == "host":
            t0 = time.perf_counter()
            done = len(self.spans.seconds["pb.batch"])
            scored = self._host_blocks(max_batches, t0 + seconds)
            return (time.perf_counter() - t0, self.spans.seconds["pb.batch"][done:],
                    [(t, s.to_dict()) for t, s in scored])
        answers, lat = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and (max_batches is None or len(lat) < max_batches):
            first = self.next_block * self.batch
            tb = time.perf_counter()
            scores = self.batch_scores()
            lat.append(time.perf_counter() - tb)
            answers += [(first + j, s.to_dict()) for j, s in enumerate(scores)]
        return time.perf_counter() - t0, lat, answers

    def _host_blocks(self, blocks: int | None, deadline: float) -> list:
        """The host feed's stream from the next block on (``HostEngine.stream``)."""
        scored = self.program.stream(self.next_block, blocks, deadline)
        self.next_block += len(scored) // self.batch
        return scored

    def traced_window(self, seconds: float):
        """``window`` under the profiler: (answers, trace)."""
        self.spans.traced = True
        try:
            with recording(self.device.type == "cuda") as rec:
                _, _, answers = self.window(seconds)
        finally:
            self.spans.traced = False
        return answers, rec["trace"]

    def free_program(self) -> None:
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, answers: list, control: bool = False) -> dict:
        """The check's sample of ``answers`` against the reference: per
        family the program's widest gap ("program") and, with ``control``,
        the control's ("control")."""
        metrics = self.config["metrics"]
        picked = check.sample(answers, int(self.workload["sample"]), self.seed, self.batch)
        idx = [t for t, _ in picked]
        t0 = time.perf_counter()
        ref = check.reference_values(self.ring, idx, metrics)
        out = {"frames": idx, "reference_s": time.perf_counter() - t0,
               "program": check.gaps(check.program_values(picked), ref, metrics)}
        if control:
            out["control"] = check.gaps(check.reference_values(self.ring, idx, metrics, control=True), ref, metrics)
        return out

    def readings(self, control: bool) -> dict:
        """The readings that limits are set from, with no timed window: the
        two warm batches, the ring once round and two batches past its wrap,
        then ``gaps``."""
        for _ in range(WARM_BATCHES):
            self.batch_scores()
        _, _, answers = self.window(float("inf"), max_batches=self.ring.blocks + 2)
        self.free_program()
        return self.gaps(answers, control)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float, device="cuda",
             root: Path = ROOT, size=None) -> dict:
    """One run of cell ``name``: its result line as a dict (``run.py``
    prints it).  ``size`` (width, height) replaces the configuration's, for
    rehearsals on the CPU."""
    bench = benchmark(root)
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    marks = [("imports", time.perf_counter())]
    cell = Cell(name, seed, device, root=root, size=size)
    marks.append(("engine and ring", time.perf_counter()))
    for _ in range(WARM_BATCHES):
        cell.batch_scores()
        marks.append(("warm batch", time.perf_counter()))
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    # What set-up made lives through the window: keep the collector off it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    split = [(n, t - p) for (n, t), (_, p) in zip(marks, [("start", t_start)] + marks[:-1])]
    print("set-up: " + ", ".join(f"{n} {s:.3f} s" for n, s in split), file=sys.stderr)
    records = None
    if trace and cell.records_spans:
        profiling.take()
        with profiling.tracing():
            window_s, lat, answers = cell.window(seconds)
        records = profiling.take()
    else:
        window_s, lat, answers = cell.window(seconds)
    spans_s = cell.spans.take()
    tr = None
    if trace:
        traced, tr = cell.traced_window(min(seconds, TRACE_SECONDS))
        print(f"window: {len(answers) / window_s:.2f} frames/s untraced, "
              f"{len(traced) / tr.window_s():.2f} traced", file=sys.stderr)
        answers += traced
    dev = device_info(cell.device, entry["chips"])
    cell.free_program()
    run = Run(setup_s, window_s, len(lat) * cell.batch, lat, spans_s, cell.work, tr, records)
    correct, checks = check.judge(cell.gaps(answers)["program"], cell.workload["limits"])
    failed = sum(1 for _, s in answers if not s or not all(v == v for v in s.values()))
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        spec = next(x for x in bench["per_layer" if trace else "end_to_end"] if x["name"] == m)
        value = reader(m, root)(run)
        if value is not None:
            metrics[m] = {"value": value, "unit": spec["unit"]}
    result = {"correct": bool(correct and failed == 0), "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result
