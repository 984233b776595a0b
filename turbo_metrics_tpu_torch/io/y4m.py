"""YUV4MPEG2 (Y4M) raw video source — pure NumPy, zero-decode.

The fastest input path: planar YUV frames read straight off disk and shipped
to the device.  Supports 8/10/12/16-bit 4:2:0, 4:2:2 and 4:4:4 (and
monochrome), limited or full range via the non-standard XCOLORRANGE
extension used by ffmpeg.
"""

from __future__ import annotations

import io as _io
from typing import BinaryIO, Optional

import numpy as np

from turbo_metrics_tpu_torch.color.characteristics import height_fallback
from turbo_metrics_tpu_torch.io.frame_source import FormatIdentifier, FrameSource, RawFrame

Y4M_MAGIC = b"YUV4MPEG2"

_COLORSPACES = {
    "420": (8, "420"),
    "420jpeg": (8, "420"),
    "420mpeg2": (8, "420"),
    "420paldv": (8, "420"),
    "420p10": (10, "420"),
    "420p12": (12, "420"),
    "420p16": (16, "420"),
    "422": (8, "422"),
    "422p10": (10, "422"),
    "422p12": (12, "422"),
    "422p16": (16, "422"),
    "444": (8, "444"),
    "444p10": (10, "444"),
    "444p12": (12, "444"),
    "444p16": (16, "444"),
    "mono": (8, "mono"),
    "mono10": (10, "mono"),
    "mono12": (12, "mono"),
}


def _chroma_dims(subsampling: str, h: int, w: int) -> tuple[int, int]:
    """(ch, cw) of one chroma plane for a subsampling mode."""
    if subsampling == "444":
        return h, w
    if subsampling == "422":
        return h, (w + 1) // 2
    return (h + 1) // 2, (w + 1) // 2


class Y4MFrameSource(FrameSource):
    def __init__(self, f: BinaryIO, *, path: Optional[str] = None):
        self._f = f
        header = _read_line(f)
        if not header.startswith(Y4M_MAGIC):
            raise ValueError("not a Y4M stream")
        self._width = self._height = 0
        self.fps = (0, 0)
        self.interlacing = "p"
        self.aspect = (0, 0)
        self.depth, self.subsampling = 8, "420"
        self.full_range = False
        for tok in header.split()[1:]:
            tag, val = chr(tok[0]), tok[1:].decode()
            if tag == "W":
                self._width = int(val)
            elif tag == "H":
                self._height = int(val)
            elif tag == "F":
                n, d = val.split(":")
                self.fps = (int(n), int(d))
            elif tag == "I":
                self.interlacing = val
            elif tag == "A":
                n, d = val.split(":")
                self.aspect = (int(n), int(d))
            elif tag == "C":
                cs = val.lower()
                if cs not in _COLORSPACES:
                    raise ValueError(f"unsupported Y4M colorspace: {val}")
                self.depth, self.subsampling = _COLORSPACES[cs]
            elif tag == "X" and val.upper().startswith("COLORRANGE="):
                self.full_range = val.upper().endswith("FULL")
        if not self._width or not self._height:
            raise ValueError("Y4M header missing dimensions")
        self._itemsize = 1 if self.depth == 8 else 2
        h, w = self._height, self._width
        if self.subsampling == "mono":
            self._frame_bytes = h * w * self._itemsize
        else:
            ch, cw = _chroma_dims(self.subsampling, h, w)
            self._frame_bytes = (h * w + 2 * ch * cw) * self._itemsize
        self._count = self._count_frames(path)

    def _count_frames(self, path: Optional[str]) -> int:
        """Frame count from file size when seekable (for progress reporting)."""
        try:
            pos = self._f.tell()
            self._f.seek(0, _io.SEEK_END)
            end = self._f.tell()
            self._f.seek(pos)
        except (OSError, AttributeError):
            return 0
        # Each frame: b"FRAME" + optional params + "\n" + payload; assume
        # plain "FRAME\n" (6 bytes) which ffmpeg writes.
        return max(0, (end - pos) // (6 + self._frame_bytes))

    def format_id(self) -> FormatIdentifier:
        return FormatIdentifier("y4m", f"rawvideo-{self.depth}bit", "numpy")

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    def color_characteristics(self):
        cc = height_fallback(self._height)
        return cc, ("full" if self.full_range else "limited")

    def frame_count(self) -> int:
        return self._count

    def next_frame(self) -> Optional[RawFrame]:
        line = _read_line(self._f, allow_eof=True)
        if line is None:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("corrupt Y4M: missing FRAME marker")
        payload = self._f.read(self._frame_bytes)
        if len(payload) < self._frame_bytes:
            return None
        dtype = np.uint8 if self.depth == 8 else np.uint16
        h, w = self._height, self._width
        buf = np.frombuffer(payload, dtype=dtype)
        y = buf[: h * w].reshape(h, w)
        chroma = 420
        if self.subsampling == "mono":
            ch, cw = (h + 1) // 2, (w + 1) // 2
            neutral = 1 << (self.depth - 1)
            uv = np.full((ch, cw, 2), neutral, dtype=dtype)
        else:
            chroma = int(self.subsampling)
            ch, cw = _chroma_dims(self.subsampling, h, w)
            u = buf[h * w : h * w + ch * cw].reshape(ch, cw)
            v = buf[h * w + ch * cw :].reshape(ch, cw)
            uv = np.stack([u, v], axis=-1)
        return RawFrame(
            y=y, uv=uv, depth=self.depth, full_range=self.full_range,
            chroma=chroma,
        )

    def close(self) -> None:
        self._f.close()


def _read_line(f: BinaryIO, *, allow_eof: bool = False) -> Optional[bytes]:
    out = bytearray()
    while True:
        b = f.read(1)
        if not b:
            if allow_eof and not out:
                return None
            raise EOFError("unexpected EOF in Y4M header")
        if b == b"\n":
            return bytes(out)
        out += b
