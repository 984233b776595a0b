"""IVF container reader (parity with codec-bitstream/src/ivf.rs:22-76)."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

IVF_MAGIC = b"DKIF"

FOURCC_CODEC = {
    b"AV01": "av1",
    b"AV1\x00": "av1",
    b"VP80": "vp8",
    b"VP90": "vp9",
    b"AVC1": "h264",
    b"H264": "h264",
}


@dataclass
class IvfHeader:
    fourcc: bytes
    width: int
    height: int
    timebase_num: int
    timebase_den: int
    frames: int
    header_len: int

    @property
    def codec(self) -> Optional[str]:
        return FOURCC_CODEC.get(self.fourcc)


def read_header(f: BinaryIO) -> IvfHeader:
    data = f.read(32)
    if len(data) < 32 or data[:4] != IVF_MAGIC:
        raise ValueError("not an IVF file")
    (_version, length) = struct.unpack_from("<HH", data, 4)
    fourcc = data[8:12]
    w, h = struct.unpack_from("<HH", data, 12)
    den, num = struct.unpack_from("<II", data, 16)
    frames = struct.unpack_from("<I", data, 24)[0]
    if length > 32:
        f.read(length - 32)
    return IvfHeader(fourcc, w, h, num, den, frames, length)


def read_packet(f: BinaryIO) -> Optional[tuple[bytes, int]]:
    """Returns (payload, pts) or None at EOF."""
    hdr = f.read(12)
    if len(hdr) < 12:
        return None
    size, pts = struct.unpack("<IQ", hdr)
    payload = f.read(size)
    if len(payload) < size:
        return None
    return payload, pts


def iter_packets(f: BinaryIO) -> Iterator[tuple[bytes, int]]:
    while True:
        pkt = read_packet(f)
        if pkt is None:
            return
        yield pkt
