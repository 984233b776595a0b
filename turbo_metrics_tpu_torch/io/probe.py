"""Input probing for the port: Y4M files and stdin.

Other inputs (images, IVF, MKV, MP4, TS and elementary streams, which the
JAX package decodes through its native libav shim and Pillow) are not ported
yet and raise an error that names the ROADMAP.md item.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import BinaryIO, Union

from turbo_metrics_tpu_torch.io.frame_source import FrameSource
from turbo_metrics_tpu_torch.io.y4m import Y4M_MAGIC, Y4MFrameSource

PROBE_LEN = 64


class ChainReader:
    """Sequential reader serving a probed prefix, then the rest of a stream.

    Lets us peek magic bytes from a non-seekable source (stdin) and still
    hand the complete byte stream to a downstream consumer.
    """

    def __init__(self, prefix: bytes, rest: BinaryIO, name: str = "<stream>"):
        self._prefix = prefix
        self._pos = 0
        self._rest = rest
        self.name = name

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            out = self._prefix[self._pos :] + self._rest.read()
            self._pos = len(self._prefix)
            return out
        out = b""
        if self._pos < len(self._prefix):
            out = self._prefix[self._pos : self._pos + n]
            self._pos += len(out)
            n -= len(out)
        if n > 0:
            out += self._rest.read(n)
        return out

    def seekable(self) -> bool:
        return False

    def close(self) -> None:
        self._rest.close()


def create_source(path: Union[str, Path], *, use_stdin: bool = False) -> FrameSource:
    """Open a Y4M file (or '-' for stdin) as a FrameSource."""
    if use_stdin or str(path) == "-":
        raw = sys.stdin.buffer
        prefix = raw.read(PROBE_LEN)
        f, name = ChainReader(prefix, raw, name="<stdin>"), None
    else:
        f = open(path, "rb")
        prefix = f.read(PROBE_LEN)
        f.seek(0)
        name = str(path)
    if prefix.startswith(Y4M_MAGIC):
        return Y4MFrameSource(f, path=name)
    f.close()
    raise NotImplementedError(
        f"{name or '<stdin>'}: only Y4M input is ported to turbo_metrics_tpu_torch "
        "yet (ROADMAP.md Queue 1 item 4, inputs); use turbo_metrics_tpu for "
        "images and compressed video"
    )
