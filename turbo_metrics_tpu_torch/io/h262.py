"""MPEG-2 (H.262) bitstream utilities: sequence header + display extension.

Parity role of codec-bitstream/src/h262.rs: recover dimensions and colour
description (H.273 code points) from the elementary stream headers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

SEQ_HEADER = b"\x00\x00\x01\xb3"
EXTENSION = b"\x00\x00\x01\xb5"


@dataclass
class H262SequenceInfo:
    width: int
    height: int
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2


def parse_sequence(data: bytes) -> Optional[H262SequenceInfo]:
    """Scan a bitstream chunk for sequence_header + sequence_display_extension."""
    i = data.find(SEQ_HEADER)
    if i == -1:
        return None
    p = data[i + 4 :]
    if len(p) < 8:
        return None
    width = (p[0] << 4) | (p[1] >> 4)
    height = ((p[1] & 0xF) << 8) | p[2]
    info = H262SequenceInfo(width, height)

    # sequence_display_extension: extension start code, id 2 (high nibble).
    j = i
    while True:
        j = data.find(EXTENSION, j + 1)
        if j == -1 or j + 5 >= len(data):
            break
        ext_id = data[j + 4] >> 4
        if ext_id == 2:  # sequence display extension
            b = data[j + 4 :]
            # video_format u(3) after the 4-bit id; colour_description u(1)
            colour_description = (b[0] >> 0) & 1
            if colour_description and len(b) >= 4:
                info.colour_primaries = b[1]
                info.transfer_characteristics = b[2]
                info.matrix_coefficients = b[3]
            break
    return info
