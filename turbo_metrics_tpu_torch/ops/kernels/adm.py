"""Kernel #18: ADM's four levels of DWT, decoupling, CSF, masking and cube
sums.

``adm_stats`` launches ``tm_adm_level`` (csrc/adm.cu) once per level on a
CUDA tensor, each level reading the approximation bands the one before
wrote, and runs its plain twin ``adm_stats_ref`` (ops/adm.py) on a CPU
tensor.  It replaces the JAX package's ``_adm_level_run``
(turbo_metrics_tpu/ops/pallas/adm.py:442) behind ``adm_stats_pallas``
(l.420), with the math of the JAX package's jnp path (ops/adm.py), which the
JAX engine runs.  A level is one fused tile kernel and the f64 reduction of
its partials: the row-filtered and band planes stay in shared memory.

``columns=(lo, hi)`` and ``frame=(x0, frame_w)``: the owned level-0 columns
of a pair that holds columns x0 .. of a frame_w wide frame; each level
then sums the owned band columns inside the frame's centre region
(``adm.level_windows``) in place of the region's own.  Every A band is
still written whole.

Width sharding (``adm_width_sharded``; parallel/mesh.py ``shard_over_width``
calls it): each strip of the frame's columns is cut once, at upload, with
owned edges on multiples of A = 16 = 2^4 and a halo of H = 32 columns on
each side (clipped at the frame's edges), and sums its owned window.  Why
these:
  * A: a strip starting at a multiple of 2^4 holds whole band columns of
    every DWT level, so its level-l band column j is the frame's column
    x0 / 2^(l+1) + j, and a strip's edge at the frame's right edge is the
    frame's edge on every level (the same symmetric extension and
    reflections there);
  * H: a db2 output i reads inputs 2i - 1 .. 2i + 2 (ops/adm.py), and the
    3x3 mask one band pixel on each side.  An owned band pixel j of level
    3 (DWT level 4, at level-0 column 16 j >= own_lo) reads band pixels j -
    1 .. j + 1, which read level-3 inputs from 2 j - 3, level-2 inputs
    from 4 j - 7, level-1 inputs from 8 j - 15 and level-0 columns from
    16 j - 31: 31 columns to the left; to the right up to 16 j + 46 <=
    own_hi + 30 (16 j <= own_hi - 16, own_hi a multiple of 16 inside the
    frame).  The shallower levels reach less.  Samples the cut extends at a
    strip's inner edge reach no owned band pixel: H = 31 rounded up to a
    multiple of A;
  * the summed window of level l is built in the frame's band
    coordinates: the owned band columns [own_lo / 2^(l+1), ceil(own_hi /
    2^(l+1))) intersected with the frame's centre columns [left_l, cw_l -
    left_l), then made strip-local; rows keep the frame's ``top`` (strips
    cut columns only), and ``adm.adm_score`` is given the frame's height
    and width;
  * the strips' f32 (B, 4, 3, 2) sums add in f64 on the first device and
    round once to f32: only the grouping of the sums changes.
The halo costs (w + 2 H (n - 1)) / w of the columns: 1.00833, 1.025 and
1.05833 over 2, 4 and 8 strips at 7680 columns.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import adm
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W
from turbo_metrics_tpu_torch.ops.kernels.vif import check_pair
from turbo_metrics_tpu_torch.parallel.mesh import (
    add_strips,
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    upload,
)

# The strips of a width-sharded call: owned edges on multiples of 2^4 and a
# halo of 32 columns (module docstring).
STRIP_ALIGNMENT = 1 << adm.NUM_LEVELS
STRIP_HALO = 32

_TAPS = (ctypes.c_float * 8)(*np.concatenate([adm.DB2_LO, adm.DB2_HI]).astype(np.float32))


def adm_stats_ref(pair, *, columns=None, frame=None):
    """Plain twin of ``adm_stats`` (same arguments and result)."""
    check_pair(pair)
    windows = None if columns is None and frame is None else adm.level_windows(pair.shape[-1], columns, frame)
    return adm.adm_stats(pair[0], pair[1], backend="jnp", windows=windows)


def adm_blocks(ch: int, cw: int, top: int, left: int, columns=None) -> int:
    """Partial blocks per frame of a ch x cw band plane: the 32x8 blocks
    (PART_W x PART_H) of its centre region [top, ch-top) x [left, cw-left),
    or of [top, ch-top) x [clo, chi) with ``columns`` = (clo, chi); the
    count of ``tm_adm_blocks`` (csrc/adm.cu)."""
    clo, chi = (left, cw - left) if columns is None else columns
    return -(-(chi - clo) // PART_W) * -(-(ch - 2 * top) // PART_H)


def level_scratch(bsz: int, h: int, w: int, dev, columns=None) -> torch.Tensor:
    """The six f32 partials of every 32x8 block of the summed window (the
    centre region, or its rows and the band columns ``columns``) of B
    frames of an h x w level input: a level's only scratch, since the tile
    kernel keeps its row-filtered and band planes in shared memory."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    top, _, left, _ = adm.center_region(ch, cw)
    return torch.empty(bsz * adm_blocks(ch, cw, top, left, columns) * 6, dtype=torch.float32, device=dev)


def adm_stats(pair: torch.Tensor, *, columns=None, frame=None) -> torch.Tensor:
    """Per-level, per-band centre-region cube sums of a (2, B, h, w) f32
    (reference, distorted) luma pair in 8-bit units -> (B, 4, 3, 2) f32:
    [..., band, 0] = sum |masked csf*r|^3, [..., band, 1] = sum |csf*o|^3,
    bands (H, V, D); with ``columns`` / ``frame`` (module docstring) over
    each level's ``adm.level_windows``."""
    check_pair(pair)
    windows = None if columns is None and frame is None else adm.level_windows(pair.shape[-1], columns, frame)
    if pair.device.type == "cpu":
        return adm_stats_ref(pair, columns=columns, frame=frame)
    if pair.device.type != "cuda":
        raise ValueError(f"adm_stats runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    _, bsz, h, w = pair.shape
    dev = pair.device
    sums = torch.empty((bsz, adm.NUM_LEVELS, 3, 2), dtype=torch.float32, device=dev)
    x = pair
    with launch_stream(dev) as stream:
        for level in range(adm.NUM_LEVELS):
            ch, cw = (h + 1) // 2, (w + 1) // 2
            top, _, left, _ = adm.center_region(ch, cw)
            clo, chi = (left, cw - left) if windows is None else windows[level]
            last = level + 1 == adm.NUM_LEVELS
            approx = None if last else torch.empty((2, bsz, ch, cw), dtype=torch.float32, device=dev)
            parts = level_scratch(bsz, h, w, dev, (clo, chi))
            rf_hv, rf_d = adm.csf_rfactors(level)
            check(
                lib.tm_adm_level(
                    x.data_ptr(), bsz, h, w, _TAPS, float(np.float32(rf_hv)), float(np.float32(rf_d)),
                    float(np.float32(adm.COS_1DEG_SQ)), float(np.float32(adm.DECOUPLE_EPS)),
                    float(adm.MASK_CENTRE), float(adm.MASK_EDGE), top, clo, chi,
                    approx.data_ptr() if approx is not None else None, parts.data_ptr(),
                    sums[:, level].data_ptr(), adm.NUM_LEVELS * 6, stream,
                ),
                "tm_adm_level",
            )
            x, h, w = approx, ch, cw
    adm_stats.launches += 1
    return sums


adm_stats.launches = 0


def adm_width_sharded(fn, mesh, *, in_ndims):
    """``adm_stats``, the fixed-point ``integer_adm_stats``
    (ops/kernels/integer_adm.py, whose docstring derives the same plan) or
    the plain entry ops/adm.py ``adm_stats`` with one frame's columns split
    over ``mesh`` (module docstring; ``shard_over_width`` calls this).
    ``fn``: one of them, bare or through functools.partial
    (``integer_adm_stats`` with its keyword ``depth``, the plain entry with
    ``backend``, ``integer`` and ``depth``, this module's ``adm_stats`` with
    none); its input the (2, B, h, w) pair (f32, or the luma codes, whose
    dtype each strip keeps), ``in_ndims`` (4,), or for the plain entry (B,
    h, w) ``y_ref`` and ``y_dis``, ``in_ndims`` (3, 3), each strip stacked
    into the pair of the wrapper that the entry's route runs
    (``plain_strip_route``).  Each call plans the strips
    (``spatial_sharding``: owned edges on multiples of 16, a halo of 32
    columns), and each strip, under its device and its stream
    (``launch_shards``), cuts its columns of the inputs (``strip_input``)
    and sums its owned part of every level's centre region (``columns`` and
    ``frame``); the strips' (B, 4, 3, 2) sums add in f64 on
    ``mesh.devices[0]`` and round once to f32.  ``ValueError`` where a strip
    would own fewer than 16 columns.  A mesh of one runs ``fn`` unchanged
    on its device."""
    # Imported here: that module imports this one.
    from turbo_metrics_tpu_torch.ops import routes
    from turbo_metrics_tpu_torch.ops.kernels.integer_adm import integer_adm_stats

    base, kw = partial_keywords(fn)
    entries = {adm_stats: ((4,), set()), integer_adm_stats: ((4,), {"depth"}),
               adm.adm_stats: ((3, 3), {"backend", "integer", "depth"})}
    if base not in entries:
        raise TypeError("adm_width_sharded takes ops.kernels.adm.adm_stats, "
                        f"ops.kernels.integer_adm.integer_adm_stats or ops.adm.adm_stats, not {fn!r}")
    ndims, keywords = entries[base]
    if tuple(in_ndims) != ndims:
        raise ValueError(f"{fn!r} takes inputs of {ndims} dims, got in_ndims={tuple(in_ndims)}")
    unknown = set(kw) - keywords
    if unknown:
        raise TypeError(f"{base.__name__} takes no keywords {sorted(unknown)} under width sharding")
    dest = mesh.devices[0]
    routes.kernel_route(kw.get("backend"), dest)  # an unknown backend name raises here

    def sharded(*args):
        check_inputs(args, in_ndims)
        if mesh.size == 1:
            return fn(*(upload(a, dest) for a in args))
        w = args[0].shape[-1]
        plan = spatial_sharding(mesh, w, alignment=STRIP_ALIGNMENT, halo=STRIP_HALO)

        def strip_sums(k, dev):
            s = plan[k]
            parts = [strip_input(a, s, dev) for a in args]
            if base is adm.adm_stats:
                run, pair = plain_strip_route(*parts, **kw)
            else:
                run, pair = functools.partial(base, **kw), parts[0]
            return run(pair, columns=s.columns, frame=(s.lo, w))

        return add_strips(launch_shards(strip_sums, mesh), dest).float()

    return sharded


def plain_strip_route(y_ref, y_dis, *, backend=None, integer=False, depth=8):
    """(the wrapper that ops/adm.py ``adm_stats`` runs on these planes, the
    pair it reads): its kernel route's (``adm.kernel_pair``), or in its
    plain route's place the plain twin of the same kernel, which takes the
    same window (``columns``, ``frame``)."""
    from turbo_metrics_tpu_torch.ops import routes
    from turbo_metrics_tpu_torch.ops.kernels.integer_adm import integer_adm_stats_ref

    route = adm.kernel_pair(y_ref, y_dis, integer=integer, depth=depth) \
        if routes.kernel_route(backend, y_ref.device) else None
    if route is not None:
        return route
    if integer:
        return functools.partial(integer_adm_stats_ref, depth=depth), routes.code_pair(y_ref, y_dis, depth)
    return adm_stats_ref, routes.f32_pair(y_ref, y_dis)
