"""Inputs at the branch points of the conversion kernels (#5, #6) and of
XPSNR's block-statistics kernel (#13).

``chip_smoke.py`` holds the kernels to their plain twins at these inputs on
the card; tests/test_torch_formats.py and tests/test_torch_xpsnr.py hold the
twins to the JAX package at the same inputs on the CPU.
"""

from __future__ import annotations

import numpy as np

from turbo_metrics_tpu_torch.ops import colorspace

# The luma types of #13, as (numpy type, bit depth): u8 and u16 planes, and
# the int32 luma codes of RGB sources.
XPSNR_LUMA = {"u8": (np.uint8, 8), "u16": (np.uint16, 10), "int32": (np.int32, 8)}

# #13's branch points, as (h, w, reference luma, distorted luma): widths on
# either side of one XPSNR block (a u8 lane's 16-byte chunk) and of two, and
# on either side of a warp's row segment (30 chunks at u8 and u16: 480 and 240
# samples; 28 at int32: 112); heights of one row and on either side of one
# block row; and every instance whose distorted type differs from the
# reference's (the distorted chunk sized to the reference's sample count,
# shifted left or right to the reference's depth).
XPSNR_EDGE_CASES = [
    ((1, 15, 16, 17)[i % 4], w, ref_type, ref_type)
    for ref_type, seg in (("u8", 480), ("u16", 240), ("int32", 112))
    for i, w in enumerate((15, 16, 17, 31, 32, 33, seg - 1, seg + 1))
] + [
    (17, 33, "u16", "u8"), (16, 241, "u16", "u8"), (9, 30, "u8", "u16"), (67, 99, "u8", "int32"),
    (17, 111, "int32", "u8"), (15, 113, "u16", "int32"),
]


def threshold_codes(depth: int, full_range: bool) -> np.ndarray:
    """Luma code values at 0, at the range's ends and two on either side of
    the codes where the BT.709 (v = 0.0812) and sRGB (v = 0.0393) transfer
    functions switch from their linear toe to their power segment."""
    rng = colorspace.sample_range(depth, full_range)
    top = (1 << depth) - 1
    codes = {0, rng.minimum, rng.minimum + rng.luma_range, top}
    for v in (0.08124285829863521, 12.92 * 0.0030412825):
        c = int(rng.minimum + v * rng.luma_range)
        codes.update(range(c - 2, c + 4))
    return np.array(sorted(x for x in codes if 0 <= x <= top))
