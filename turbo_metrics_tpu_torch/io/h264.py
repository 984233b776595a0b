"""H.264/AVC bitstream utilities: Annex B scanning, AVCC conversion, SPS/VUI.

Host-side parity with codec-bitstream/src/h264.rs (NaluType :52-73, AVCC
extradata -> Annex B :168-254, Annex B NAL reader :256-298), plus a real SPS
parser so the pipeline can recover dimensions, bit depth, signal range and
H.273 colour code points without a hardware decoder's sequence callback.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Iterator, Optional

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics

ANNEXB_START = b"\x00\x00\x01"


class NaluType(IntEnum):
    UNSPECIFIED = 0
    SLICE_NON_IDR = 1
    SLICE_PART_A = 2
    SLICE_PART_B = 3
    SLICE_PART_C = 4
    SLICE_IDR = 5
    SEI = 6
    SPS = 7
    PPS = 8
    AUD = 9
    END_OF_SEQ = 10
    END_OF_STREAM = 11
    FILLER = 12
    SPS_EXT = 13
    PREFIX = 14
    SUBSET_SPS = 15


def iter_annexb_nalus(data: bytes) -> Iterator[bytes]:
    """Yield NAL units (without start codes) from an Annex B stream."""
    i = data.find(ANNEXB_START)
    while i != -1:
        start = i + 3
        j = data.find(ANNEXB_START, start)
        end = len(data) if j == -1 else (j - 1 if j > 0 and data[j - 1] == 0 else j)
        nalu = data[start:end].rstrip(b"\x00") if j == -1 else data[start:end]
        if nalu:
            yield nalu
        i = j
    return


class AvccConfig:
    """Parsed avcC extradata (ISO 14496-15), as carried in MKV CodecPrivate.

    Mirrors avcc_extradata_to_annexb (h264.rs:168-198).
    """

    def __init__(self, data: bytes):
        if len(data) < 7 or data[0] != 1:
            raise ValueError("not avcC extradata")
        self.nal_length_size = (data[4] & 0x3) + 1
        self.sps: list[bytes] = []
        self.pps: list[bytes] = []
        pos = 5
        num_sps = data[pos] & 0x1F
        pos += 1
        for _ in range(num_sps):
            ln = int.from_bytes(data[pos : pos + 2], "big")
            pos += 2
            self.sps.append(data[pos : pos + ln])
            pos += ln
        num_pps = data[pos]
        pos += 1
        for _ in range(num_pps):
            ln = int.from_bytes(data[pos : pos + 2], "big")
            pos += 2
            self.pps.append(data[pos : pos + ln])
            pos += ln

    def annexb_headers(self) -> bytes:
        out = bytearray()
        for nalu in self.sps + self.pps:
            out += b"\x00\x00\x00\x01" + nalu
        return bytes(out)


def avcc_into_annexb(packet: bytes, nal_length_size: int = 4) -> list[bytes]:
    """Split a length-prefixed AVCC packet into Annex B framed NAL units.

    One NALU per element, each with a 4-byte start code (the reference feeds
    NALUs one at a time to the parser, h264.rs:235-254).
    """
    out = []
    pos = 0
    n = len(packet)
    while pos + nal_length_size <= n:
        ln = int.from_bytes(packet[pos : pos + nal_length_size], "big")
        pos += nal_length_size
        out.append(b"\x00\x00\x00\x01" + packet[pos : pos + ln])
        pos += ln
    return out


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class BitReader:
    """MSB-first bit reader with Exp-Golomb support."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


@dataclass
class SpsInfo:
    width: int
    height: int
    depth: int
    full_range: bool
    colour_primaries: int
    transfer_characteristics: int
    matrix_coefficients: int

    def color_characteristics(self) -> ColorCharacteristics:
        return ColorCharacteristics.from_code_points(
            self.colour_primaries, self.matrix_coefficients, self.transfer_characteristics
        )


_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}


def parse_sps(nalu: bytes) -> SpsInfo:
    """Parse a SPS NAL unit (including its header byte)."""
    if (nalu[0] & 0x1F) != NaluType.SPS:
        raise ValueError("not an SPS NALU")
    r = BitReader(unescape_rbsp(nalu[1:]))
    profile_idc = r.u(8)
    r.u(8)  # constraint flags + reserved
    r.u(8)  # level_idc
    r.ue()  # sps id
    chroma_format_idc = 1
    depth = 8
    if profile_idc in _HIGH_PROFILES:
        chroma_format_idc = r.ue()
        if chroma_format_idc == 3:
            r.u(1)  # separate_colour_plane_flag
        depth = r.ue() + 8  # bit_depth_luma_minus8
        r.ue()  # bit_depth_chroma_minus8
        r.u(1)  # qpprime_y_zero_transform_bypass
        if r.u(1):  # seq_scaling_matrix_present
            count = 8 if chroma_format_idc != 3 else 12
            for i in range(count):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    r.ue()  # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed
    pic_width_in_mbs = r.ue() + 1
    pic_height_in_map_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field
    r.u(1)  # direct_8x8_inference
    crop_l = crop_r = crop_t = crop_b = 0
    if r.u(1):  # frame_cropping
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()

    width = pic_width_in_mbs * 16
    height = pic_height_in_map_units * 16 * (1 if frame_mbs_only else 2)
    # Crop units for 4:2:0 (the only subsampling this pipeline decodes).
    sub_w = 2 if chroma_format_idc in (1, 2) else 1
    sub_h = 2 if chroma_format_idc == 1 else 1
    sub_h *= 1 if frame_mbs_only else 2
    width -= (crop_l + crop_r) * sub_w
    height -= (crop_t + crop_b) * sub_h

    full_range = False
    cp = tc = mc = 2  # unspecified
    if r.u(1):  # vui_parameters_present
        if r.u(1):  # aspect_ratio_info
            if r.u(8) == 255:
                r.u(16)
                r.u(16)
        if r.u(1):  # overscan_info
            r.u(1)
        if r.u(1):  # video_signal_type
            r.u(3)  # video_format
            full_range = bool(r.u(1))
            if r.u(1):  # colour_description
                cp = r.u(8)
                tc = r.u(8)
                mc = r.u(8)
    return SpsInfo(width, height, depth, full_range, cp, tc, mc)


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last, nxt = 8, 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        if nxt:
            last = nxt


def find_sps(annexb: bytes) -> Optional[SpsInfo]:
    for nalu in iter_annexb_nalus(annexb):
        if (nalu[0] & 0x1F) == NaluType.SPS:
            return parse_sps(nalu)
    return None
