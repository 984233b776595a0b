"""The program of a host-fed cell: the port's engine with its own host path.

``HostEngine`` is ``turbo_metrics_tpu_torch.engine.TurboMetrics`` driven
as the CLI drives it once frames are decoded: ``compute_all`` over two
frame sources with the engine's ``FramePrefetcher`` (its default depth, 2),
so every batch is stacked by the engine's ``_planes`` (``np.stack``) and
uploaded from pageable host memory, on the main thread, in series with the
step.  Nothing of the engine is replaced: ``compute_frames``, ``_planes``,
``_step`` and ``_scores`` only run inside the harness's spans (``pb.batch``
from a batch's hand-over to its scores as Python floats; ``pb.planes``
around each stack and upload, inside ``pb.launch``; ``pb.wait``, a device
synchronisation that the scoring's first readback would make anyway;
``pb.score``), so a traced run's idle gaps name the upload.

The frames are the cell's ring (traffic.py), copied once at set-up into
pageable NumPy planes, one array per block and input, each frame a
``RawFrame`` of views into them as a decoder hands them over.  Two
``RingSource``s serve them from a stream position, cycling the ring without
a break (the stream state crosses the wrap), and end together at the first
whole batch once a deadline has passed or a number of batches was served
(``Stop``).

glibc's allocator serves a block above its mmap threshold from fresh pages
and hands them back on free; below it, from its heap, which it trims or
keeps by where the process's other blocks lie.  The threshold starts at
128 KiB and rises to the size of the first large block freed (at most
32 MiB), so whether a batch's stacks were faulted in anew hung on each
process's layout: under the profiler, whose allocations change it, the host
path ran ~1.7 times as fast as in the same run's untraced window.
``HostEngine`` fixes the threshold at its starting value
(``fix_mmap_threshold``): every stack of both windows takes fresh pages, as
a block above 32 MiB (a 4K batch's) always does.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time

import torch

from turbo_metrics_tpu_torch.engine import TurboMetrics
from turbo_metrics_tpu_torch.io.frame_source import FormatIdentifier, FrameSource, RawFrame

from portbench.program import colour, engine_metrics


# glibc's starting mmap threshold (M_MMAP_THRESHOLD in mallopt(3)).
MMAP_THRESHOLD = 128 * 1024
M_MMAP_THRESHOLD = -3


def fix_mmap_threshold() -> None:
    """Hold glibc's mmap threshold at its starting value for the rest of the
    process, its rise with the blocks freed switched off (module
    docstring)."""
    if ctypes.CDLL(None).mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD) != 1:
        raise OSError("mallopt(M_MMAP_THRESHOLD) was refused")


def host_frames(ring, side: str, fmt: dict) -> list[RawFrame]:
    """The ring's frames of input ``side`` in stream order, as decoded host
    frames over pageable copies of its planes, one copy a block."""
    if ring.pair is not None:
        planes = tuple(p[:, 0 if side == "ref" else 1] for p in ring.pair)
    else:
        planes = getattr(ring, side)
    frames = []
    for k in range(ring.blocks):
        block = [p[k].cpu().numpy() for p in planes]
        for j in range(ring.batch):
            if fmt["kind"] == "rgb":
                frames.append(RawFrame(rgb=block[0][j], depth=fmt["depth"]))
            else:
                frames.append(RawFrame(y=block[0][j], uv=block[1][j], depth=fmt["depth"],
                                       full_range=fmt["range"] == "full", chroma=fmt["chroma"]))
    return frames


class Stop:
    """Where the two sources of one stream end: at the first block that
    either asks to open once ``deadline`` has passed or ``blocks`` blocks
    from ``first`` were opened (None: no count).  A block that one source
    has opened opens for the other too, so both end at one whole batch."""

    def __init__(self, first: int, blocks: int | None, deadline: float):
        self.last = first + blocks if blocks is not None else None
        self.deadline = deadline
        self.opened = first - 1
        self.end = None
        self._lock = threading.Lock()

    def opens(self, block: int) -> bool:
        with self._lock:
            if self.end is None and ((self.last is not None and block >= self.last)
                                     or time.perf_counter() >= self.deadline):
                self.end = max(block, self.opened + 1)
            if self.end is not None and block >= self.end:
                return False
            self.opened = max(self.opened, block)
            return True


class RingSource(FrameSource):
    """One input's host frames from stream frame ``start`` on, frame ``i``
    being the ring's ``i % len(frames)``, until ``stop`` closes a block."""

    def __init__(self, frames: list[RawFrame], cc, batch: int, start: int, stop: Stop):
        self.frames, self.cc, self.batch, self.next, self.stop = frames, cc, batch, start, stop

    def format_id(self) -> FormatIdentifier:
        return FormatIdentifier(None, "raw", "ring")

    @property
    def width(self) -> int:
        return self.frames[0].width

    @property
    def height(self) -> int:
        return self.frames[0].height

    def color_characteristics(self):
        return self.cc

    def frame_count(self) -> int:
        return 0

    def next_frame(self) -> RawFrame | None:
        i = self.next
        if i % self.batch == 0 and not self.stop.opens(i // self.batch):
            return None
        self.next += 1
        return self.frames[i % len(self.frames)]


class HostEngine(TurboMetrics):
    """The engine fed host frames through its own stack, upload and
    prefetcher (module docstring)."""

    def __init__(self, config: dict, width: int, height: int, *, batch: int | None, device):
        fix_mmap_threshold()
        super().__init__(width, height, engine_metrics(config), batch=batch, device=device)
        self.spans = lambda name: contextlib.nullcontext()

    def attach(self, ring, workload: dict) -> None:
        """Feed the engine from pageable host copies of ``ring``, whose
        inputs ``workload`` names."""
        if ring.batch != self.batch:
            raise ValueError(f"the ring's batch {ring.batch} is not the engine's {self.batch}")
        self.cc_ref, self.cc_dis = colour(workload["ref"]), colour(workload["dis"])
        self.frames_ref = host_frames(ring, "ref", workload["ref"])
        self.frames_dis = host_frames(ring, "dis", workload["dis"])

    def stream(self, first_block: int, blocks: int | None, deadline: float) -> list:
        """The ring's blocks from ``first_block`` on through ``compute_all``
        with its prefetcher, until ``Stop`` ends them: (stream index,
        ``FrameScores``) of every frame scored."""
        stop = Stop(first_block, blocks, deadline)
        start = first_block * self.batch
        scored = []
        self.compute_all(RingSource(self.frames_ref, self.cc_ref, self.batch, start, stop),
                         RingSource(self.frames_dis, self.cc_dis, self.batch, start, stop),
                         on_frame=lambda s: scored.append((start + len(scored), s)), prefetch=True)
        return scored

    def compute_frames(self, *args, **kwargs):
        with self.spans("pb.batch"):
            return super().compute_frames(*args, **kwargs)

    def _planes(self, *args, **kwargs):
        with self.spans("pb.planes"):
            return super()._planes(*args, **kwargs)

    def _step(self, *args, **kwargs):
        with self.spans("pb.launch"):
            return super()._step(*args, **kwargs)

    def _scores(self, *args, **kwargs):
        with self.spans("pb.wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self.spans("pb.score"):
            return super()._scores(*args, **kwargs)
