"""Reading the program's own spans (``tm.`` ranges) out of a trace.

While its recording is on (``turbo_metrics_tpu_torch.utils.profiling``),
the program marks each of its spans as a profiler range of the same name,
and the profiler mirrors each range onto the device's timeline as an
annotation that covers the kernels launched inside it.  ``trace.Trace``
takes every record on the device for an operation of the device, so those
mirrors would count as busy time there.  ``ProgramTrace`` is ``Trace`` with
the ``tm.`` records set apart: the host's ranges in ``program``, the
device's mirrors in ``mirrors``, and neither in ``device``; the device's
readings (``busy_s``, ``batch_device_s``, ``device_ops``) are then those of
the same device records.  Its idle gaps take the innermost span around
each gap's middle, the program's or the harness's; without ``tm.`` ranges
(a program that records none) its labels are ``Trace``'s.

Nothing of the program is imported: the ranges are read by name.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from portbench.trace import Trace, _union

PREFIX = "tm."
# Trace.idle_gaps' label of a gap inside a batch and outside its phases.
OUTSIDE_PHASES = "pb.batch (outside its phases)"
# A device operation inside no ``tm.`` mirror.
OUTSIDE_PROGRAM = "outside tm. ranges"


def _covering(intervals: list, t: int):
    """The interval of ``intervals`` (sorted, never overlapping) that
    covers ``t``, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return intervals[i] if i >= 0 and t < intervals[i][1] else None


def _innermost(spans: dict, t: int, depth: dict | None = None):
    """The name of the innermost span around ``t``: the latest start, then
    the earliest end, then the deepest by ``depth`` (a mirror shares its
    bounds with the mirror of its parent where both cover the same
    kernels); None where no span covers ``t``.  ``spans``: name -> (start,
    end) sorted by start, one name's spans never overlapping."""
    best = None
    for name, intervals in spans.items():
        iv = _covering(intervals, t)
        if iv is not None:
            key = (iv[0], -iv[1], (depth or {}).get(name, 0))
            if best is None or key > best[0]:
                best = (key, name)
    return None if best is None else best[1]


@dataclass
class ProgramTrace(Trace):
    """``Trace`` with the program's ``tm.`` ranges set apart: ``program``,
    the host's ranges by name, each a sorted list of (start, end) in ns;
    ``mirrors``, their annotations on the device (name, start, end)."""

    program: dict = field(default_factory=dict)
    mirrors: list = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "ProgramTrace":
        from torch.autograd import DeviceType

        events = list(events)
        base = Trace.from_events([e for e in events if not e.name().startswith(PREFIX)])
        program: dict = {}
        mirrors = []
        for e in events:
            if not e.name().startswith(PREFIX):
                continue
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                mirrors.append((e.name(), start, end))
            else:
                program.setdefault(e.name(), []).append((start, end))
        for v in program.values():
            v.sort()
        mirrors.sort(key=lambda m: m[1])
        return cls(base.spans, base.device, program, mirrors)

    def gaps(self) -> list[tuple[int, int]]:
        """The device's idle intervals inside the window."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy(lo, hi):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, by the innermost span around each gap's middle, of the
        program's or the harness's ('between batches' outside every batch)."""
        spans = {**self.spans, **self.program}
        totals: dict = {}
        for a, b in self.gaps():
            name = _innermost(spans, (a + b) // 2)
            label = "between batches" if name is None else OUTSIDE_PHASES if name == "pb.batch" else name
            totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]

    def labelled_share(self, span: str = "pb.launch"):
        """(idle seconds whose middle lies inside the harness's ``span``, the
        share of them that ``idle_gaps`` puts under a ``tm.`` span)."""
        spans = {**self.spans, **self.program}
        inside = labelled = 0
        for a, b in self.gaps():
            mid = (a + b) // 2
            if _covering(self.spans[span], mid) is not None:
                inside += b - a
                if _innermost(spans, mid).startswith(PREFIX):
                    labelled += b - a
        return inside / 1e9, (labelled / inside if inside else None)

    def device_families(self, top: int = 10) -> list:
        """[innermost ``tm.`` mirror around each device operation's middle,
        device seconds] in the window, the union of the operations' time
        under each label."""
        lo, hi = self.window
        mirrors: dict = {}
        for name, a, b in self.mirrors:
            mirrors.setdefault(name, []).append((a, b))
        # How many of the program's host ranges are open where a name's first
        # range starts: its depth in the nesting.
        depth = {name: sum(_covering(v, first[0][0]) is not None for v in self.program.values())
                 for name, first in self.program.items()}
        per: dict = {}
        for _, a, b in self.device:
            if b > lo and a < hi:
                label = _innermost(mirrors, (a + b) // 2, depth) or OUTSIDE_PROGRAM
                per.setdefault(label, []).append((max(a, lo), min(b, hi)))
        totals = {k: sum(b - a for a, b in _union(v)) / 1e9 for k, v in per.items()}
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]
