"""K-int-ADM: ADM's four levels under the fixed-point conventions.

``integer_adm_stats`` launches ``tm_integer_adm_level``
(csrc/integer_adm.cu) once per level on a CUDA tensor, each level reading
the int32 approximation bands the one before wrote, and runs its plain twin
``integer_adm_stats_ref`` (ops/integer_adm.py) on a CPU tensor.  No TPU
kernel stands behind it: the JAX package computes ``integer_adm_stats``
(turbo_metrics_tpu/ops/integer_adm.py:107) with jnp.  ``integer_adm_levels``
runs the same launches with the kernel's check stores on, for holding its
bands and gate against ``integer_adm_levels_ref`` bit for bit.

``columns=(lo, hi)`` and ``frame=(x0, frame_w)``: the owned level-0 columns
of a pair that holds columns x0 .. of a frame_w wide frame; each level
then sums the owned band columns inside the frame's centre region
(``adm.level_windows``) in place of the region's own.  Every A band is
still written whole.

Width sharding (ops/kernels/adm.py ``adm_width_sharded``, which
parallel/mesh.py ``shard_over_width`` calls for this entry too): the float
ADM's plan, A = 16 and H = 32, holds here, derived from this schedule
(ops/integer_adm.py) rather than taken over:
  * each integer analysis pass's output i reads inputs 2i - 1 .. 2i + 2
    with half-sample symmetric extension (rows first, then columns, the
    float db2's reach), rounded per output; the pre-rounding of the codes,
    the (x - 128) << 8 of level 0 and the angle gate are per sample, and
    the float finish's 3x3 mask adds one band pixel on each side;
  * A: a strip starting at a multiple of 2^4 holds whole band columns of
    every DWT level, so its level-l band column j is the frame's column
    x0 / 2^(l+1) + j, and the last strip's right edge is the frame's on
    every level (the same extension and reflections);
  * H: an owned band pixel j of level 3 (level-0 column 16 j >= own_lo)
    reads band pixels j - 1 .., which read level-3 inputs from 2 j - 3,
    level-2 inputs from 4 j - 7, level-1 inputs from 8 j - 15 and level-0
    columns from 16 j - 31: 31 columns to the left; to the right up to 16 j
    + 46 <= own_hi + 30.  The shallower levels reach less.  H = 31 rounded
    up to a multiple of A;
  * each level's window is the frame's owned band columns inside the
    frame's centre columns, made strip-local; the strips' f32 (B, 4, 3, 2)
    sums add in f64 and round once to f32; a strip keeps the codes' dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import adm, integer_adm
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.adm import level_scratch
from turbo_metrics_tpu_torch.ops.kernels.integer_vif import check_codes, pre_shift
from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES

_TAPS = (ctypes.c_int * 8)(*np.concatenate(integer_adm.adm_coeffs_q()).astype(np.int32).tolist())


def _windows(pair, columns, frame):
    """Each level's summed band columns (``adm.level_windows``), None for
    the centre regions'."""
    return None if columns is None and frame is None else adm.level_windows(pair.shape[-1], columns, frame)


def integer_adm_stats_ref(pair, *, depth=8, columns=None, frame=None):
    """Plain twin of ``integer_adm_stats`` (same arguments and result)."""
    check_codes(pair)
    pre_shift(depth)
    return integer_adm.integer_adm_stats(pair[0], pair[1], depth=depth, windows=_windows(pair, columns, frame))


def integer_adm_levels_ref(pair, *, depth=8):
    """Plain twin of ``integer_adm_levels``."""
    check_codes(pair)
    pre_shift(depth)
    return integer_adm.integer_adm_levels(pair[0], pair[1], depth=depth)


def _run(pair, depth, levels: bool, columns=None, frame=None):
    check_codes(pair)
    shift = pre_shift(depth)
    windows = _windows(pair, columns, frame)
    if pair.device.type != "cuda":
        raise ValueError(f"integer ADM runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    _, bsz, h, w = pair.shape
    dev = pair.device
    sums = torch.empty((bsz, adm.NUM_LEVELS, 3, 2), dtype=torch.float32, device=dev)
    out, x = [], pair
    with launch_stream(dev) as stream:
        for level in range(adm.NUM_LEVELS):
            ch, cw = (h + 1) // 2, (w + 1) // 2
            top, _, left, _ = adm.center_region(ch, cw)
            clo, chi = (left, cw - left) if windows is None else windows[level]
            last = level + 1 == adm.NUM_LEVELS
            approx = None if last and not levels else torch.empty((2, bsz, ch, cw), dtype=torch.int32, device=dev)
            surface = torch.empty((7, bsz, ch, cw), dtype=torch.int32, device=dev) if levels else None
            parts = level_scratch(bsz, h, w, dev, (clo, chi))
            rf_hv, rf_d = adm.csf_rfactors(level)
            check(
                lib.tm_integer_adm_level(
                    x.data_ptr(), int(level == 0), DTYPE_CODES[x.dtype], shift if level == 0 else 0, bsz, h, w,
                    _TAPS, float(integer_adm.COS_1DEG_SQ_F32),
                    float(np.float32((1 << (level + 1)) / (1 << integer_adm.Q_BAND))),
                    float(np.float32(rf_hv)), float(np.float32(rf_d)), float(np.float32(adm.DECOUPLE_EPS)),
                    float(adm.MASK_CENTRE), float(adm.MASK_EDGE), top, clo, chi,
                    None if approx is None else approx.data_ptr(), parts.data_ptr(), sums[:, level].data_ptr(),
                    adm.NUM_LEVELS * 6, None if surface is None else surface.data_ptr(), stream,
                ),
                "tm_integer_adm_level",
            )
            integer_adm_stats.launches += 1
            if levels:
                lv = dict(zip(integer_adm.BANDS, surface[:6].unbind(0)))
                lv["angle_ok"] = surface[6] != 0
                lv["a_ref"], lv["a_dis"] = approx.unbind(0)
                out.append(lv)
            x, h, w = approx, ch, cw
    return sums, out


def integer_adm_stats(pair: torch.Tensor, *, depth: int = 8, columns=None, frame=None) -> torch.Tensor:
    """Per-level, per-band centre-region cube sums of a (2, B, h, w) pair of
    (reference, distorted) luma codes at ``depth`` bits under the
    fixed-point conventions -> (B, 4, 3, 2) f32: [..., band, 0] = sum
    |masked csf*r|^3, [..., band, 1] = sum |csf*o|^3, bands (H, V, D); with
    ``columns`` / ``frame`` (module docstring) over each level's
    ``adm.level_windows``."""
    if pair.device.type == "cpu":
        return integer_adm_stats_ref(pair, depth=depth, columns=columns, frame=frame)
    return _run(pair, depth, False, columns, frame)[0]


integer_adm_stats.launches = 0


def integer_adm_levels(pair: torch.Tensor, *, depth: int = 8) -> list[dict]:
    """The integer surface of every level, from the kernel's check stores:
    the bands o_h .. t_d ((B, ch, cw) int32), the gate (bool) and the A
    bands it writes ('a_ref', 'a_dis', int32; at the last level too).
    Counts its launches with ``integer_adm_stats``; not on the main path."""
    if pair.device.type == "cpu":
        return integer_adm_levels_ref(pair, depth=depth)
    return _run(pair, depth, True)[1]
