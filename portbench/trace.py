"""Reading the profiler's trace of a run: the harness's spans and the
device's operations, and the numbers the per-layer readers take from them.

``Spans`` times the harness's spans on the host clock in every run, and
while a trace records also marks them as profiler ranges.  ``recording``
traces the device's operations and those ranges alone: the profiler keeps
no host record of each operator, whose cost would slow the host's part of
a batch several fold.  ``kernel_name`` is the port's trace reading
(utils/profiling.py), copied so that later changes to the program do not
move the yardstick.  The events are the profiler's raw Kineto records,
whose host and device times share one clock.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

# A batch, and inside it the engine's step (every launch), the wait for the
# device, and the host's scoring (the readbacks and float64 scores); in a
# host-fed cell also the engine's stack and upload of a batch's frames,
# inside the step.
SPANS = ("pb.batch", "pb.launch", "pb.wait", "pb.score", "pb.planes")


class Spans:
    """The seconds of each span on the host clock (``seconds[name]``, one
    entry per span); while ``traced``, each span is also a profiler range."""

    def __init__(self):
        self.seconds: dict = {name: [] for name in SPANS}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            rng = record_function(name)
        else:
            rng = contextlib.nullcontext()
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def take(self) -> dict:
        """The seconds recorded so far, cleared here."""
        out, self.seconds = self.seconds, {name: [] for name in SPANS}
        return out


@contextlib.contextmanager
def recording(cuda: bool):
    """Trace the device's operations and the user-scope ranges (the spans);
    yields a dict whose ``"trace"`` is the ``Trace`` once the block exits."""
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import (
        ProfilerActivity,
        ProfilerConfig,
        ProfilerState,
        RecordScope,
        _ExperimentalConfig,
    )

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    out: dict = {}
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
        result = _disable_profiler()
    out["trace"] = Trace.from_events(result.events())


def kernel_name(raw: str) -> str:
    """A profiler kernel name without its return type, namespace and
    arguments: 'reduce_parts_kernel<6>'; memsets and copies by their kind."""
    if raw.startswith("Memset"):
        return "memset"
    if raw.startswith("Memcpy"):
        return raw.split(" (", 1)[0].lower().replace(" ", "_")
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(", 1)[0]


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


@dataclass
class Trace:
    """The traced window: ``spans`` by name, each a sorted list of (start,
    end) in ns; ``device`` the device's operations (name, start, end)."""

    spans: dict = field(default_factory=dict)
    device: list = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "Trace":
        from torch.autograd import DeviceType

        spans: dict = {name: [] for name in SPANS}
        device = []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.name() in spans:
                # A span is recorded on the host and mirrored on the device
                # as an annotation; the host's record is the span.
                if e.device_type() != DeviceType.CUDA:
                    spans[e.name()].append((start, end))
            elif e.device_type() == DeviceType.CUDA:
                device.append((kernel_name(e.name()), start, end))
        for v in spans.values():
            v.sort()
        device.sort(key=lambda d: d[1])
        return cls(spans, device)

    @property
    def window(self) -> tuple[int, int]:
        batches = self.spans["pb.batch"]
        return batches[0][0], batches[-1][1]

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def busy(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """The union of device activity inside [lo, hi)."""
        return _clip(_union((a, b) for _, a, b in self.device), lo, hi)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy(*self.window)) / 1e9

    def batch_device_s(self) -> list[float]:
        """Per batch, the seconds in which the device ran an operation
        during the batch's span (the loop is closed: a batch's device work
        runs inside its span)."""
        busy = _union((a, b) for _, a, b in self.device)
        out = []
        for lo, hi in self.spans["pb.batch"]:
            out.append(sum(b - a for a, b in _clip(busy, lo, hi)) / 1e9)
        return out

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        lo, hi = self.window
        totals: dict = {}
        for name, a, b in self.device:
            if b > lo and a < hi:
                totals[name] = totals.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, by the innermost harness span around each gap's middle
        ('between batches' outside every batch)."""
        lo, hi = self.window
        busy = self.busy(lo, hi)
        gaps = []
        t = lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        inner = [(name, self.spans[name]) for name in ("pb.planes", "pb.launch", "pb.wait", "pb.score", "pb.batch")]
        totals: dict = {}
        for a, b in gaps:
            mid = (a + b) // 2
            label = "between batches"
            for name, spans in inner:
                if _covers(spans, mid):
                    label = name if name != "pb.batch" else "pb.batch (outside its phases)"
                    break
            totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def _covers(spans, t: int) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]
