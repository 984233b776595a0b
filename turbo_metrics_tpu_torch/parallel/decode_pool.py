"""Chunked multi-worker decode: N decoders over one file, seek-partitioned.

The reference hides decode behind NVDEC hardware; the port decodes on the
host CPU, where one decoder's rate can cap the pipeline below the device's
metric rate.  This pool scales decode across cores the way the reference's
--skip/--frames windowing shards runs (turbo-metrics/src/lib.rs:40-54), but
in-process: K workers each own a NativeVideoSource over the same file, seek
to their chunk's first frame (tm_seek -> av_seek_frame to the preceding
keyframe, then decode-discard up to the exact index), decode C frames, and
the consumer reassembles global order.

Requires a seekable CFR file with timestamps (NativeVideoSource.can_seek);
callers fall back to plain sequential decode otherwise.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics
from turbo_metrics_tpu_torch.io.frame_source import (
    FormatIdentifier,
    FrameSource,
    RawFrame,
)

log = logging.getLogger("turbo_metrics_tpu_torch")

_END = object()  # chunk terminator: EOF inside this chunk


class ChunkedVideoSource(FrameSource):
    """FrameSource that decodes with ``workers`` parallel seek-partitioned
    decoders (chunk c -> worker c % workers, ``chunk`` frames per chunk)."""

    def __init__(self, path: str, *, workers: int = 2, chunk: int = 32):
        from turbo_metrics_tpu_torch.io.native import NativeVideoSource

        self._path = path
        self._workers = max(1, int(workers))
        self._chunk = max(1, int(chunk))
        self._meta_src = NativeVideoSource(path)
        if not self._meta_src.can_seek():
            raise ValueError(
                "chunked decode needs a seekable CFR file with timestamps"
            )
        self._skip = 0
        self._started = False
        self._threads: list[threading.Thread] = []
        self._chunk_queues: dict[int, queue.Queue] = {}
        self._queues_lock = threading.Lock()
        self._next_chunk = 0  # next chunk index to claim (workers)
        self._claim_lock = threading.Lock()
        self._eof_chunk: Optional[int] = None  # first chunk known to end early
        self._consume_chunk = 0
        self._error: Optional[BaseException] = None

    # -- FrameSource metadata (from the probe decoder) -----------------------

    def format_id(self) -> FormatIdentifier:
        return self._meta_src.format_id()

    @property
    def width(self) -> int:
        return self._meta_src.width

    @property
    def height(self) -> int:
        return self._meta_src.height

    def color_characteristics(self) -> tuple[ColorCharacteristics, str]:
        return self._meta_src.color_characteristics()

    def frame_count(self) -> int:
        n = self._meta_src.frame_count()
        return max(0, n - self._skip) if n else 0

    def skip_frames(self, n: int) -> None:
        if self._started:
            raise RuntimeError("skip_frames must precede decoding")
        self._skip += n

    # -- worker machinery ----------------------------------------------------

    def _queue_for(self, c: int) -> queue.Queue:
        with self._queues_lock:
            q = self._chunk_queues.get(c)
            if q is None:
                q = self._chunk_queues[c] = queue.Queue(maxsize=self._chunk + 1)
            return q

    def _worker(self) -> None:
        from turbo_metrics_tpu_torch.io.native import NativeVideoSource

        try:
            src = NativeVideoSource(self._path)
            while True:
                with self._claim_lock:
                    if self._eof_chunk is not None and self._next_chunk >= self._eof_chunk:
                        return
                    c = self._next_chunk
                    self._next_chunk += 1
                start = self._skip + c * self._chunk
                q = self._queue_for(c)
                if not src.seek_to_frame(start):
                    # Seek target beyond EOF (or stream went unseekable).
                    with self._claim_lock:
                        if self._eof_chunk is None or c < self._eof_chunk:
                            self._eof_chunk = c
                    q.put(_END)
                    return
                produced = 0
                while produced < self._chunk:
                    f = src.get_frame()
                    if f is None:
                        with self._claim_lock:
                            if self._eof_chunk is None or c + 1 < self._eof_chunk:
                                self._eof_chunk = c + 1
                        break
                    q.put(f)
                    produced += 1
                q.put(_END)
        except BaseException as e:
            self._error = e
            self._queue_for(self._consume_chunk).put(_END)

    def _start(self) -> None:
        self._started = True
        for _ in range(self._workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    # -- consumer -------------------------------------------------------------

    def next_frame(self) -> Optional[RawFrame]:
        if not self._started:
            self._start()
        while True:
            if self._error is not None:
                raise self._error
            c = self._consume_chunk
            with self._claim_lock:
                if self._eof_chunk is not None and c >= self._eof_chunk and c >= self._next_chunk:
                    return None
            try:
                item = self._queue_for(c).get(timeout=0.5)
            except queue.Empty:
                continue  # re-check error/termination conditions
            if item is _END:
                with self._queues_lock:
                    self._chunk_queues.pop(c, None)
                with self._claim_lock:
                    drained = self._eof_chunk is not None and c + 1 >= self._eof_chunk
                self._consume_chunk = c + 1
                if drained:
                    return None
                continue
            return item

    def close(self) -> None:
        self._meta_src.close()
