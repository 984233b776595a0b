"""Profiling and timing helpers.

The mapping of the reference's observability hooks (SURVEY.md section 5):
cuProfilerStart/Stop + Nsight -> ``device_trace`` (torch.profiler, a
Chrome/Perfetto trace); CuEvent timing -> ``Timer`` and ``time_ms`` (CUDA
events on the card, the host clock on the CPU); ``cuda_kernel_records``
reads the device time of each kernel a call launches (the dissect tool's
reading, tools/kernel_dissect.py).

The program's own spans and counters (``span``, ``count``) are recorded
while ``tracing`` is on, and ``take`` hands them over: per span name its
count, host seconds and self seconds (its time less its child spans'), per
counter its sum.  Off, the default, a span is one shared null context and a
count returns at once: no clock, no allocation, no device synchronisation
and no profiler call.  On, while torch.profiler records, each span is also
a ``record_function`` range of its name, so a trace holds the spans on the
clock of the device's records; ``device_trace`` switches the recording on
for its block.  Each thread keeps its own stack of open spans (the frame
prefetcher decodes in a thread of its own).

The JAX package's ``dump_hlo`` and ``enable_compilation_cache`` have no
counterpart: there is no XLA program to dump or cache.  The kernels are
built once per hash of their sources into the package's ``_build/`` by
ops/kernels/_build.py, which is the port's compilation cache; the
counterpart of the reference's CUDA-graph dot dump
(``torch.cuda.CUDAGraph.debug_dump``) comes with CUDA graphs (ROADMAP
Queue 1 item 3b).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# The name given to the profiler's records of cudaMemsetAsync: device work of
# the calls that issue one (#16 zeroes its row sums before its kernel adds
# into them).
MEMSET = "memset"

_TRACES = itertools.count()


@dataclass
class SpanStats:
    """One span name's record: how often it closed, its host seconds in
    all and without its children's, and the names of the spans it was
    opened in (None: no open span) with their counts."""

    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    parents: dict = field(default_factory=dict)


@dataclass
class Records:
    """What ``take`` hands over: ``spans`` by name, ``counters`` by name."""

    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def per(self, name: str = "tm.batch") -> int:
        """How many spans ``name`` closed (the batches by default), at least 1."""
        stats = self.spans.get(name)
        return max(stats.count if stats else 0, 1)


class _Recorder:
    """The process's one record of spans and counters (module docstring)."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: dict = {}
        self._counters: dict = {}

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add_span(self, name: str, parent, total_ns: int, self_ns: int) -> None:
        with self._lock:
            stats = self._spans.get(name)
            if stats is None:
                stats = self._spans[name] = SpanStats()
            stats.count += 1
            stats.total_s += total_ns / 1e9
            stats.self_s += self_ns / 1e9
            stats.parents[parent] = stats.parents.get(parent, 0) + 1

    def add_count(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def take(self) -> Records:
        with self._lock:
            out = Records(self._spans, self._counters)
            self._spans, self._counters = {}, {}
        return out


_RECORDER = _Recorder()
_NULL_SPAN = contextlib.nullcontext()


class _Span:
    """An open span while the recording is on (``span``)."""

    __slots__ = ("name", "parent", "child_ns", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0

    def __enter__(self):
        stack = _RECORDER.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _RECORDER.stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += total
        _RECORDER.add_span(self.name, None if parent is None else parent.name, total, total - self.child_ns)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    the recording is on; off, the one shared null context."""
    if not _RECORDER.on:
        return _NULL_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recording is on."""
    if _RECORDER.on:
        _RECORDER.add_count(name, n)


def recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _RECORDER.on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch the recording of spans and counters on (or off) for the
    block; the state before it is restored after it."""
    before, _RECORDER.on = _RECORDER.on, bool(on)
    try:
        yield
    finally:
        _RECORDER.on = before


def take() -> Records:
    """The spans and counters recorded so far, cleared here."""
    return _RECORDER.take()


def to_host(t: torch.Tensor, out: torch.Tensor | None = None) -> np.ndarray:
    """A result's values on the host as a NumPy array: the copy is a
    ``tm.readback`` span and its bytes count as ``readback_bytes``.  With
    ``out``, a host tensor of ``t``'s shape and type that the caller keeps
    and reuses, the values are copied into it and its NumPy view is
    returned, valid until the caller's next copy into ``out``."""
    with span("tm.readback"):
        a = t.detach().cpu().numpy() if out is None else out.copy_(t.detach()).numpy()
    count("readback_bytes", a.nbytes)
    return a


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nest of dicts, tuples and lists."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return set()
    return set().union(*(_cuda_devices(t) for t in tree))


def synchronize(result) -> None:
    """Wait for the work on every CUDA device that holds a tensor of
    ``result`` (a tensor or a nest of them); nothing on the CPU."""
    for dev in _cuda_devices(result):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the block (host activity, and the
    card's kernels where CUDA is present) and write it into ``log_dir``
    (``turbo_metrics_trace`` in the temporary directory where None) as a
    Chrome/Perfetto trace file, ``trace_<pid>_<n>.json``.  Yields
    ``log_dir``.  The program's spans are recorded in the block (``tracing``)
    and appear in the trace as ranges of their names.  The counterpart of
    the reference's cuProfilerStart/Stop bracketing
    (cudarse-driver/src/lib.rs:50-56)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "turbo_metrics_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, tracing():
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


@dataclass
class Timer:
    """Wall-clock timer that syncs the device (CuEvent::elapsed_since
    analog).  ``samples`` holds seconds."""

    samples: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, result=None):
        """Time the block; at its end, wait for the devices of ``result``
        (a tensor or a nest of them, read then: a list the block fills
        works)."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            synchronize(result)
        self.samples.append(time.perf_counter() - t0)

    def time_fn(self, fn, *args, iters: int = 10, warmup: int = 1) -> float:
        """Steady-state seconds per call of ``fn(*args)``: CUDA events
        where its result lies on the card, the host clock on the CPU."""
        r = None
        for _ in range(max(warmup, 1)):
            r = fn(*args)
        devs = _cuda_devices(r)
        if not devs:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / iters
        else:
            dev = min(devs, key=lambda d: d.index or 0)
            with torch.cuda.device(dev):
                dt = time_ms(lambda: fn(*args), iters, dev, warmup=0) / 1e3
        self.samples.append(dt)
        return dt


def time_ms(fn, iters: int, device: torch.device = torch.device("cuda"), warmup: int = 2) -> float:
    """Mean time of fn() over ``iters`` calls after warm-up: CUDA events on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(raw: str) -> str:
    """A profiler kernel name without its return type, namespace and
    arguments: 'reduce_parts_kernel<6>'."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(", 1)[0]


def cuda_kernel_records(run) -> list:
    """[(kernel name, ms)] of the CUDA kernels and memsets (``MEMSET``) that
    run() launches, by torch.profiler, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy")),
        key=lambda e: e.time_range.start,
    )
    return [(MEMSET if e.name.startswith("Memset") else kernel_name(e.name), e.time_range.elapsed_us() / 1e3)
            for e in events]
