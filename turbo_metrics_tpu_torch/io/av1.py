"""AV1 sequence-header parsing: dimensions, bit depth, colour config.

Parity role of codec-bitstream/src/av1.rs (which extracts the sequence header
from MKV codec-private data), extended with a real parse of the colour config
so the pipeline learns depth/range/H.273 code points without a decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics
from turbo_metrics_tpu_torch.io.h264 import BitReader

OBU_SEQUENCE_HEADER = 1


@dataclass
class Av1SequenceInfo:
    width: int
    height: int
    depth: int
    monochrome: bool
    full_range: bool
    colour_primaries: int
    transfer_characteristics: int
    matrix_coefficients: int

    def color_characteristics(self) -> ColorCharacteristics:
        return ColorCharacteristics.from_code_points(
            self.colour_primaries, self.matrix_coefficients, self.transfer_characteristics
        )


def extract_seq_header_obu(codec_private: bytes) -> Optional[bytes]:
    """MKV CodecPrivate for AV1 is an av1C box: 4 config bytes then OBUs
    (av1.rs:4-7 simply skips the first 4 bytes)."""
    if len(codec_private) < 5:
        return None
    return codec_private[4:]


def _leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos + i + 1
    raise ValueError("invalid leb128")


def find_sequence_header(obus: bytes) -> Optional[bytes]:
    """Scan a low-overhead OBU stream for the sequence header payload."""
    pos = 0
    n = len(obus)
    while pos < n:
        header = obus[pos]
        obu_type = (header >> 3) & 0xF
        has_ext = (header >> 2) & 1
        has_size = (header >> 1) & 1
        pos += 1
        if has_ext:
            pos += 1
        if has_size:
            size, pos = _leb128(obus, pos)
        else:
            size = n - pos
        if obu_type == OBU_SEQUENCE_HEADER:
            return obus[pos : pos + size]
        pos += size
    return None


def parse_sequence_header(payload: bytes) -> Av1SequenceInfo:
    """Parse sequence_header_obu() far enough to reach color_config()."""
    r = BitReader(payload)
    seq_profile = r.u(3)
    r.u(1)  # still_picture
    reduced = r.u(1)
    decoder_model_info_present = 0
    if reduced:
        r.u(5)  # seq_level_idx
    else:
        if r.u(1):  # timing_info_present
            r.u(32)  # num_units_in_display_tick
            r.u(32)  # time_scale
            if r.u(1):  # equal_picture_interval
                _uvlc(r)  # num_ticks_per_picture_minus_1
            decoder_model_info_present = r.u(1)
            if decoder_model_info_present:
                buffer_delay_length = r.u(5) + 1
                r.u(32)  # num_units_in_decoding_tick
                r.u(5)  # buffer_removal_time_length_minus_1
                r.u(5)  # frame_presentation_time_length_minus_1
            else:
                buffer_delay_length = 0
        else:
            buffer_delay_length = 0
        initial_display_delay_present = r.u(1)
        for _ in range(r.u(5) + 1):  # operating points
            r.u(12)  # operating_point_idc
            seq_level_idx = r.u(5)
            if seq_level_idx > 7:
                r.u(1)  # seq_tier
            if decoder_model_info_present:
                if r.u(1):  # decoder_model_present_for_this_op
                    r.u(buffer_delay_length)  # decoder_buffer_delay
                    r.u(buffer_delay_length)  # encoder_buffer_delay
                    r.u(1)  # low_delay_mode_flag
            if initial_display_delay_present:
                if r.u(1):
                    r.u(4)
    wbits = r.u(4) + 1
    hbits = r.u(4) + 1
    width = r.u(wbits) + 1
    height = r.u(hbits) + 1
    if not reduced:
        if r.u(1):  # frame_id_numbers_present
            r.u(4)
            r.u(3)
    r.u(1)  # use_128x128_superblock
    r.u(1)  # enable_filter_intra
    r.u(1)  # enable_intra_edge_filter
    if not reduced:
        r.u(1)  # enable_interintra_compound
        r.u(1)  # enable_masked_compound
        r.u(1)  # enable_warped_motion
        r.u(1)  # enable_dual_filter
        enable_order_hint = r.u(1)
        if enable_order_hint:
            r.u(1)  # enable_jnt_comp
            r.u(1)  # enable_ref_frame_mvs
        if not r.u(1):  # seq_choose_screen_content_tools
            force_sct = r.u(1)
        else:
            force_sct = 2
        if force_sct:
            if not r.u(1):  # seq_choose_integer_mv
                r.u(1)
        if enable_order_hint:
            r.u(3)  # order_hint_bits_minus_1
    r.u(1)  # enable_superres
    r.u(1)  # enable_cdef
    r.u(1)  # enable_restoration

    # color_config()
    high_bitdepth = r.u(1)
    if seq_profile == 2 and high_bitdepth:
        depth = 12 if r.u(1) else 10
    else:
        depth = 10 if high_bitdepth else 8
    monochrome = bool(r.u(1)) if seq_profile != 1 else False
    cp = tc = mc = 2
    if r.u(1):  # color_description_present
        cp, tc, mc = r.u(8), r.u(8), r.u(8)
    if monochrome:
        full_range = bool(r.u(1))
    elif cp == 1 and tc == 13 and mc == 0:
        full_range = True
    else:
        full_range = bool(r.u(1))
    return Av1SequenceInfo(width, height, depth, monochrome, full_range, cp, tc, mc)


def _uvlc(r: BitReader) -> int:
    zeros = 0
    while r.u(1) == 0:
        zeros += 1
        if zeros > 31:
            return (1 << 32) - 1
    return (1 << zeros) - 1 + (r.u(zeros) if zeros else 0)


def parse_codec_private(codec_private: bytes) -> Optional[Av1SequenceInfo]:
    obus = extract_seq_header_obu(codec_private)
    if obus is None:
        return None
    payload = find_sequence_header(obus)
    if payload is None:
        return None
    return parse_sequence_header(payload)
