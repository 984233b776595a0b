"""Colour metadata: ITU-T H.273 code points and fallback rules.

Parity with codec-bitstream's ColorCharacteristics (codec-bitstream/src/
lib.rs:40-248) and the pipeline's height-based fallback
(turbo-metrics/src/color.rs:36-78): when a stream does not signal its colour
(code point 2 = unspecified), SD content defaults to BT.601 and HD to BT.709.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class ColourPrimaries(Enum):
    RESERVED = 0
    BT709 = 1
    UNSPECIFIED = 2
    BT470M = 4
    BT601_625 = 5  # BT.470BG
    BT601_525 = 6  # SMPTE 170M
    SMPTE240 = 7
    FILM = 8
    BT2020 = 9
    SMPTE428 = 10
    P3DCI = 11
    P3D65 = 12


class MatrixCoefficients(Enum):
    IDENTITY = 0
    BT709 = 1
    UNSPECIFIED = 2
    FCC = 4
    BT601_625 = 5  # BT.470BG
    BT601_525 = 6  # SMPTE 170M
    SMPTE240 = 7
    YCGCO = 8
    BT2020_NCL = 9
    BT2020_CL = 10
    SMPTE2085 = 11
    CHROMAT_NCL = 12
    CHROMAT_CL = 13
    ICTCP = 14


class TransferCharacteristic(Enum):
    RESERVED = 0
    BT709 = 1
    UNSPECIFIED = 2
    BT470M = 4  # gamma 2.2
    BT470BG = 5  # gamma 2.8
    BT601 = 6  # = BT.709 curve
    SMPTE240 = 7
    LINEAR = 8
    LOG100 = 9
    LOG316 = 10
    XVYCC = 11
    BT1361 = 12
    SRGB = 13
    BT2020_10 = 14  # = BT.709 curve
    BT2020_12 = 15  # = BT.709 curve
    PQ = 16  # SMPTE 2084
    SMPTE428 = 17
    HLG = 18


def _from_code(enum_cls, value: int, default):
    try:
        return enum_cls(value)
    except ValueError:
        return default


@dataclass(frozen=True)
class ColorCharacteristics:
    cp: ColourPrimaries
    mc: MatrixCoefficients
    tc: TransferCharacteristic

    @classmethod
    def from_code_points(cls, cp: int, mc: int, tc: int) -> "ColorCharacteristics":
        """Decode raw H.273 code points (shared by H.264/HEVC/AV1/MPEG-2 VUI)."""
        return cls(
            cp=_from_code(ColourPrimaries, cp, ColourPrimaries.UNSPECIFIED),
            mc=_from_code(MatrixCoefficients, mc, MatrixCoefficients.UNSPECIFIED),
            tc=_from_code(TransferCharacteristic, tc, TransferCharacteristic.UNSPECIFIED),
        )

    def or_fallback(self, other: "ColorCharacteristics") -> "ColorCharacteristics":
        """Replace unspecified fields with ``other``'s (lib.rs ``or``)."""
        return ColorCharacteristics(
            cp=other.cp if self.cp is ColourPrimaries.UNSPECIFIED else self.cp,
            mc=other.mc if self.mc is MatrixCoefficients.UNSPECIFIED else self.mc,
            tc=other.tc if self.tc is TransferCharacteristic.UNSPECIFIED else self.tc,
        )

    def is_fully_specified(self) -> bool:
        return (
            self.cp is not ColourPrimaries.UNSPECIFIED
            and self.mc is not MatrixCoefficients.UNSPECIFIED
            and self.tc is not TransferCharacteristic.UNSPECIFIED
        )


def height_fallback(height: int) -> ColorCharacteristics:
    """Guess colour characteristics from frame height (color.rs:51-78)."""
    if height <= 525:
        return ColorCharacteristics(
            ColourPrimaries.BT601_525, MatrixCoefficients.BT601_525, TransferCharacteristic.BT709
        )
    if height <= 625:
        return ColorCharacteristics(
            ColourPrimaries.BT601_625, MatrixCoefficients.BT601_625, TransferCharacteristic.BT709
        )
    return ColorCharacteristics(
        ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.BT709
    )


_MATRIX_NAME = {
    MatrixCoefficients.BT709: "bt709",
    MatrixCoefficients.BT601_525: "bt601_525",
    MatrixCoefficients.BT601_625: "bt601_625",
    MatrixCoefficients.BT2020_NCL: "bt2020",
}

_TRANSFER_NAME = {
    TransferCharacteristic.BT709: "bt709",
    TransferCharacteristic.BT601: "bt709",
    TransferCharacteristic.BT2020_10: "bt709",
    TransferCharacteristic.BT2020_12: "bt709",
    TransferCharacteristic.SRGB: "srgb",
    TransferCharacteristic.LINEAR: "linear",
    TransferCharacteristic.PQ: "pq",
    TransferCharacteristic.HLG: "hlg",
}


def matrix_name(cc: ColorCharacteristics) -> str:
    """Kernel matrix selection (color.rs:80-87, extended with BT.2020)."""
    try:
        return _MATRIX_NAME[cc.mc]
    except KeyError:
        raise NotImplementedError(f"unsupported matrix coefficients: {cc.mc}")


def transfer_name(cc: ColorCharacteristics) -> str:
    """Kernel transfer selection (color.rs:89-94, extended with PQ/HLG/sRGB)."""
    try:
        return _TRANSFER_NAME[cc.tc]
    except KeyError:
        raise NotImplementedError(f"unsupported transfer characteristic: {cc.tc}")
