"""Host-side streaming: overlap decode with compute.

Counterpart of the reference's stream-ordered decode/compute overlap
(SURVEY.md section 5 "Pipeline parallelism"): a background thread decodes
frame batches while the device crunches the previous batch.  Uploads are
plain pageable copies for now; pinned buffers and a copy stream come later.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from turbo_metrics_tpu_torch.io.frame_source import FrameSource, RawFrame
from turbo_metrics_tpu_torch.utils.profiling import span


class FramePrefetcher:
    """Background decoder producing batches of paired frames.

    ``depth`` is the number of batches buffered ahead (2 = double buffering).
    """

    def __init__(
        self,
        source_ref: FrameSource,
        source_dis: FrameSource,
        *,
        batch: int,
        depth: int = 2,
        every: int = 0,
        frames: int = 0,
    ):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker,
            args=(source_ref, source_dis, batch, every, frames),
            daemon=True,
        )
        self._thread.start()

    @staticmethod
    def _pairs(src_r, src_d, every, frames) -> Iterator[tuple[RawFrame, RawFrame]]:
        """The frame pairs to score, in order."""
        from turbo_metrics_tpu_torch.io.frame_source import ResolutionChanged

        # Decode the two streams concurrently (the reference runs ref and
        # dis decode on separate CUDA streams, lib.rs:276-293; here each
        # stream gets its own host thread — libavcodec releases the GIL).
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=2)
        decode_count = 0
        while True:
            fut_r = pool.submit(src_r.get_frame)
            fut_d = pool.submit(src_d.get_frame)
            exc = None
            fr = fd = None
            try:
                fr = fut_r.result()
            except ResolutionChanged as e:
                exc = e
            try:
                fd = fut_d.result()
            except ResolutionChanged as e:
                exc = exc or e
            if exc is not None:
                # Keep the pair lockstep across the segment boundary: an
                # already-fetched mate goes back to its source so the new
                # segment starts with matched frames.
                if fr is not None:
                    src_r.push_back(fr)
                if fd is not None:
                    src_d.push_back(fd)
                raise exc
            if fr is None or fd is None:
                return
            if every > 1 and decode_count != 0 and decode_count % every != 0:
                decode_count += 1
                continue
            if frames > 0 and decode_count >= frames:
                return
            decode_count += 1
            yield fr, fd

    def _worker(self, src_r, src_d, batch, every, frames):
        pend_r: list[RawFrame] = []
        pend_d: list[RawFrame] = []
        try:
            pairs = self._pairs(src_r, src_d, every, frames)
            more = True
            while more:
                more = False
                with span("tm.decode"):
                    for fr, fd in pairs:
                        pend_r.append(fr)
                        pend_d.append(fd)
                        if len(pend_r) >= batch:
                            more = True
                            break
                if pend_r:
                    self._q.put((pend_r, pend_d))
                    pend_r, pend_d = [], []
        except BaseException as e:  # propagate to consumer
            # Flush the partial batch first: those frames were scored-worthy
            # decodes from before the fault/reconfiguration point.
            if pend_r:
                self._q.put((pend_r, pend_d))
            self._error = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator[tuple[list[RawFrame], list[RawFrame]]]:
        while True:
            with span("tm.prefetch.wait"):
                item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item
