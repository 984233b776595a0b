"""Minimal Matroska/WebM (EBML) demuxer.

Parity role of the reference's matroska-demuxer usage
(turbo-metrics/src/input_video.rs:222-349): find the first video track,
expose codec id / codec-private / dimensions / colour metadata, and iterate
packets in decode order (SimpleBlock + BlockGroup, all three lacing modes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

EBML_MAGIC = b"\x1a\x45\xdf\xa3"

# Element IDs (with marker bits, as read from the stream).
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMESTAMP_SCALE = 0x2AD7B1
_DURATION = 0x4489
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_DEFAULT_DURATION = 0x23E383
_VIDEO = 0xE0
_PIXEL_WIDTH = 0xB0
_PIXEL_HEIGHT = 0xBA
_COLOUR = 0x55B0
_COLOUR_MATRIX = 0x55B1
_COLOUR_RANGE = 0x55B9
_COLOUR_TRANSFER = 0x55BA
_COLOUR_PRIMARIES = 0x55BB
_CLUSTER = 0x1F43B675
_CLUSTER_TIMESTAMP = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1

CODEC_IDS = {
    "V_MPEG4/ISO/AVC": "h264",
    "V_MPEGH/ISO/HEVC": "hevc",
    "V_AV1": "av1",
    "V_VP8": "vp8",
    "V_VP9": "vp9",
    "V_MPEG2": "mpeg2",
    "V_MPEG1": "mpeg1",
}


def _read_vint(f: BinaryIO, keep_marker: bool) -> Optional[int]:
    v = _read_vint_len(f, keep_marker)
    return None if v is None else v[0]


# Sentinel for the EBML "unknown size" marker (all value bits set).  ffmpeg
# writes unknown-size Segments and Clusters when the output is not seekable
# (pipes); such a cluster extends until the next top-level element or EOF.
UNKNOWN_SIZE = -2


def _read_vint_len(f: BinaryIO, keep_marker: bool) -> Optional[tuple[int, int]]:
    """Read an EBML vint; returns (value, total byte length).

    With ``keep_marker=False`` (sizes), the all-value-bits-set pattern is the
    spec's "unknown size" marker and is returned as ``UNKNOWN_SIZE``.
    """
    first = f.read(1)
    if not first:
        return None
    b0 = first[0]
    if b0 == 0:
        raise ValueError("invalid EBML vint")
    length = 8 - b0.bit_length()
    value = b0 if keep_marker else b0 & ((1 << (7 - length)) - 1)
    rest = f.read(length)
    if len(rest) < length:
        return None
    for b in rest:
        value = (value << 8) | b
    if not keep_marker and value == (1 << (7 * (length + 1))) - 1:
        return UNKNOWN_SIZE, length + 1
    return value, length + 1


def _read_element(f: BinaryIO) -> Optional[tuple[int, int]]:
    """Returns (element id, payload size) or None at EOF.

    ``size`` is ``UNKNOWN_SIZE`` for unknown-size elements (Segment/Cluster)."""
    eid = _read_vint(f, keep_marker=True)
    if eid is None:
        return None
    size = _read_vint(f, keep_marker=False)
    if size is None:
        return None
    return eid, size


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big")


@dataclass
class MkvTrack:
    number: int = 0
    track_type: int = 0
    codec_id: str = ""
    codec_private: bytes = b""
    pixel_width: int = 0
    pixel_height: int = 0
    default_duration_ns: int = 0
    colour_matrix: int = 2
    colour_transfer: int = 2
    colour_primaries: int = 2
    colour_range: int = 0  # 0 unspecified, 1 limited, 2 full

    @property
    def codec(self) -> Optional[str]:
        return CODEC_IDS.get(self.codec_id)


@dataclass
class MkvPacket:
    track: int
    timestamp_ns: int
    keyframe: bool
    data: bytes


class MkvDemuxer:
    """Single-pass Matroska reader exposing the first video track."""

    def __init__(self, f: BinaryIO):
        self._f = f
        self.timestamp_scale = 1_000_000
        self.duration: float = 0.0
        self.tracks: list[MkvTrack] = []
        self._cluster_end = -1
        self._cluster_ts = 0
        self._segment_end: Optional[int] = None
        self._parse_headers()

    @property
    def video_track(self) -> Optional[MkvTrack]:
        for t in self.tracks:
            if t.track_type == 1:
                return t
        return None

    def frame_count_estimate(self) -> int:
        t = self.video_track
        if t and t.default_duration_ns and self.duration:
            dur_ns = self.duration * self.timestamp_scale
            return round(dur_ns / t.default_duration_ns)
        return 0

    # -- header parsing ------------------------------------------------------

    def _parse_headers(self) -> None:
        f = self._f
        el = _read_element(f)
        if el is None or el[0] != 0x1A45DFA3:
            raise ValueError("not an EBML/Matroska file")
        f.seek(el[1], 1)  # skip EBML header payload
        el = _read_element(f)
        if el is None or el[0] != _SEGMENT:
            raise ValueError("no Matroska segment")
        # Parse top-level elements until the first cluster.
        while True:
            pos = f.tell()
            el = _read_element(f)
            if el is None:
                break
            eid, size = el
            if eid == _INFO:
                self._parse_info(f.read(size))
            elif eid == _TRACKS:
                self._parse_tracks(f.read(size))
            elif eid == _CLUSTER:
                self._cluster_end = (
                    UNKNOWN_SIZE if size == UNKNOWN_SIZE else f.tell() + size
                )
                self._cluster_ts = 0
                break
            elif size == UNKNOWN_SIZE:
                raise ValueError(
                    f"unknown-size EBML element 0x{eid:x} outside Cluster/Segment"
                )
            else:
                f.seek(size, 1)

    def _parse_info(self, data: bytes) -> None:
        for eid, payload in _iter_children(data):
            if eid == _TIMESTAMP_SCALE:
                self.timestamp_scale = _uint(payload)
            elif eid == _DURATION:
                import struct

                self.duration = (
                    struct.unpack(">f", payload)[0]
                    if len(payload) == 4
                    else struct.unpack(">d", payload)[0]
                )

    def _parse_tracks(self, data: bytes) -> None:
        for eid, payload in _iter_children(data):
            if eid == _TRACK_ENTRY:
                self.tracks.append(self._parse_track_entry(payload))

    def _parse_track_entry(self, data: bytes) -> MkvTrack:
        t = MkvTrack()
        for eid, payload in _iter_children(data):
            if eid == _TRACK_NUMBER:
                t.number = _uint(payload)
            elif eid == _TRACK_TYPE:
                t.track_type = _uint(payload)
            elif eid == _CODEC_ID:
                t.codec_id = payload.decode("ascii", "replace")
            elif eid == _CODEC_PRIVATE:
                t.codec_private = payload
            elif eid == _DEFAULT_DURATION:
                t.default_duration_ns = _uint(payload)
            elif eid == _VIDEO:
                for vid, vp in _iter_children(payload):
                    if vid == _PIXEL_WIDTH:
                        t.pixel_width = _uint(vp)
                    elif vid == _PIXEL_HEIGHT:
                        t.pixel_height = _uint(vp)
                    elif vid == _COLOUR:
                        for cid, cp_ in _iter_children(vp):
                            if cid == _COLOUR_MATRIX:
                                t.colour_matrix = _uint(cp_)
                            elif cid == _COLOUR_TRANSFER:
                                t.colour_transfer = _uint(cp_)
                            elif cid == _COLOUR_PRIMARIES:
                                t.colour_primaries = _uint(cp_)
                            elif cid == _COLOUR_RANGE:
                                t.colour_range = _uint(cp_)
        return t

    # -- packet iteration ----------------------------------------------------

    def packets(self, track_number: Optional[int] = None) -> Iterator[MkvPacket]:
        """Iterate blocks of a track (default: the first video track)."""
        if track_number is None:
            vt = self.video_track
            if vt is None:
                return
            track_number = vt.number
        f = self._f
        while True:
            if self._cluster_end == -1:
                el = _read_element(f)
                if el is None:
                    return
                eid, size = el
                if eid == _CLUSTER:
                    self._cluster_end = (
                        UNKNOWN_SIZE if size == UNKNOWN_SIZE else f.tell() + size
                    )
                    self._cluster_ts = 0
                elif size == UNKNOWN_SIZE:
                    return  # cannot skip an unknown-size non-cluster element
                else:
                    f.seek(size, 1)
                    continue
            if self._cluster_end == UNKNOWN_SIZE:
                # Unknown-size cluster: extends until the next top-level
                # element (level-1 Matroska IDs are the 4-byte class-A ids,
                # >= 0x10000000; cluster children all have 1-2 byte ids) or
                # EOF.
                while True:
                    el = _read_element(f)
                    if el is None:
                        return
                    eid, size = el
                    if eid == _CLUSTER:
                        self._cluster_end = (
                            UNKNOWN_SIZE if size == UNKNOWN_SIZE else f.tell() + size
                        )
                        self._cluster_ts = 0
                        break
                    if eid >= 0x10000000:  # next top-level element ends it
                        if size == UNKNOWN_SIZE:
                            return
                        f.seek(size, 1)
                        self._cluster_end = -1
                        break
                    if eid == _CLUSTER_TIMESTAMP:
                        self._cluster_ts = _uint(f.read(size))
                    elif eid == _SIMPLE_BLOCK:
                        yield from self._parse_block(f.read(size), track_number, simple=True)
                    elif eid == _BLOCK_GROUP:
                        for gid, gp in _iter_children(f.read(size)):
                            if gid == _BLOCK:
                                yield from self._parse_block(gp, track_number, simple=False)
                    else:
                        f.seek(size, 1)
                continue
            while f.tell() < self._cluster_end:
                el = _read_element(f)
                if el is None:
                    return
                eid, size = el
                if eid == _CLUSTER_TIMESTAMP:
                    self._cluster_ts = _uint(f.read(size))
                elif eid == _SIMPLE_BLOCK:
                    yield from self._parse_block(f.read(size), track_number, simple=True)
                elif eid == _BLOCK_GROUP:
                    for gid, gp in _iter_children(f.read(size)):
                        if gid == _BLOCK:
                            yield from self._parse_block(gp, track_number, simple=False)
                else:
                    f.seek(size, 1)
            self._cluster_end = -1

    def _parse_block(
        self, data: bytes, want_track: int, *, simple: bool
    ) -> Iterator[MkvPacket]:
        import io as _io

        bf = _io.BytesIO(data)
        track = _read_vint(bf, keep_marker=False)
        rel_ts = int.from_bytes(bf.read(2), "big", signed=True)
        flags = bf.read(1)[0]
        if track != want_track:
            return
        keyframe = bool(flags & 0x80) if simple else True
        lacing = (flags >> 1) & 0x3
        ts_ns = (self._cluster_ts + rel_ts) * self.timestamp_scale
        if lacing == 0:
            yield MkvPacket(track, ts_ns, keyframe, data[bf.tell() :])
            return
        nframes = bf.read(1)[0] + 1
        sizes: list[int] = []
        if lacing == 2:  # fixed
            remaining = len(data) - bf.tell()
            sizes = [remaining // nframes] * nframes
        elif lacing == 1:  # Xiph
            for _ in range(nframes - 1):
                s = 0
                while True:
                    b = bf.read(1)[0]
                    s += b
                    if b != 255:
                        break
                sizes.append(s)
            sizes.append(len(data) - bf.tell() - sum(sizes))
        else:  # EBML lacing
            first = _read_vint(bf, keep_marker=False)
            sizes.append(first)
            for _ in range(nframes - 2):
                # Deltas are *signed* vints: value - (2^(7*len-1) - 1).
                val, nbytes = _read_vint_len(bf, keep_marker=False)
                sizes.append(sizes[-1] + val - ((1 << (7 * nbytes - 1)) - 1))
            sizes.append(len(data) - bf.tell() - sum(sizes))
        pos = bf.tell()
        for s in sizes:
            yield MkvPacket(track, ts_ns, keyframe, data[pos : pos + s])
            pos += s




def _iter_children(data: bytes) -> Iterator[tuple[int, bytes]]:
    import io as _io

    f = _io.BytesIO(data)
    n = len(data)
    while f.tell() < n:
        el = _read_element(f)
        if el is None:
            return
        eid, size = el
        if size == UNKNOWN_SIZE:
            raise ValueError(f"unknown-size EBML element 0x{eid:x} in child context")
        payload = f.read(size)
        yield eid, payload
