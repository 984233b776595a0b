"""Kernels #14 and #15: VIF's scale 0, and scales 1-3.

``vif_scale0`` (#14) and ``vif_tail`` (#15) launch ``tm_vif_level``
(csrc/vif.cu) on CUDA tensors, once at scale 0 and once at each of scales
1-3; on CPU tensors they run their plain twins (``vif_scale0_ref``,
``vif_tail_ref``).  They replace the JAX package's ``_vif_scale_pallas``
(turbo_metrics_tpu/ops/pallas/vif.py:540) as ``vif_scale_stats_pallas``
(l.664) runs it at scale 0, and ``vif_tail_pallas`` (ops/pallas/vif_tail.py:
331).  Scale k's input is decimate2(blur(x, window k)) of scale k - 1
(ops/vif.py), so the launch at scale k - 1 emits it with the next window.

``columns=(lo, hi)``: the owned level-0 columns whose maps are summed (None:
all of them).  Scale k sums its columns j with lo <= j * 2^k < hi,
``vif.scale_columns``: [ceil(lo / 2^k), ceil(hi / 2^k)).  Every plane is
still blurred and emitted whole.

Width sharding (``vif_width_sharded``; parallel/mesh.py ``shard_over_width``
calls it): each strip of the frame's columns is cut once, at upload, with
owned edges on multiples of A = 8 = 2^3 and a halo of H = 24 columns on
each side (clipped at the frame's edges), and sums its owned window.  Why
these:
  * A: a strip starting at a multiple of 2^3 decimates in the frame's
    phase at every scale, so its scale-k column j is the frame's column
    lo / 2^k + j, and a strip's edge at the frame's right edge is the
    frame's edge at every scale (the same reflections there);
  * H: scale k's input is decimate2(blur(x, window k)) of scale k - 1
    and its map reads window k again, radii 8, 4, 2, 1.  An owned pixel of
    scale k (at level-0 column 2^k j >= own_lo) reads scale-k columns j - r_k
    .. j + r_k, which read scale k - 1 columns 2(j - r_k) - r_k .., and so
    on down: in level-0 columns 8 (scale 0), 2 * 4 + 4 = 12 (scale 1), 4 *
    2 + 2 * 2 + 4 = 16 (scale 2) and 8 + 4 + 4 + 4 = 20 (scale 3) to the
    left; to the right the same reaches from the last owned pixel, 2^k j
    <= own_hi - 2^k (own_hi a multiple of 8 inside the frame), end at
    column own_hi + 12 at most.  Samples the cut reflects at a strip's
    inner edge reach no owned pixel: H = 20 rounded up to a multiple of A;
  * the strips' f32 (B, 4, 2) sums add in f64 on the first device and round
    once to f32: only the grouping of the sums changes.
The halo costs (w + 2 H (n - 1)) / w of the columns: 1.00625, 1.01875 and
1.04375 over 2, 4 and 8 strips at 7680 columns.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import vif
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W
from turbo_metrics_tpu_torch.parallel.mesh import (
    add_strips,
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    upload,
)

# The strips of a width-sharded call: owned edges on multiples of 2^3 and a
# halo of 24 columns (module docstring).
STRIP_ALIGNMENT = 1 << (vif.NUM_SCALES - 1)
STRIP_HALO = 24

_WINDOWS: dict = {}


def _window(scale: int, device) -> torch.Tensor:
    """The f32 taps of a scale's window on ``device`` (made once)."""
    key = (scale, str(device))
    if key not in _WINDOWS:
        _WINDOWS[key] = torch.from_numpy(vif.vif_window(scale).astype(np.float32)).to(device)
    return _WINDOWS[key]


def check_pair(pair):
    """Raise unless ``pair`` is a contiguous f32 (2, B, h, w) luma pair (the
    input of VIF and ADM)."""
    if pair.ndim != 4 or pair.shape[0] != 2:
        raise ValueError(f"pair must be (2, B, h, w), got {tuple(pair.shape)}")
    if pair.dtype != torch.float32 or not pair.is_contiguous():
        raise ValueError(f"pair must be contiguous float32, got {pair.dtype}")


def _emit(x, scale):
    return vif.decimate2(vif.blur_same(x, vif.vif_window(scale))).contiguous()


def vif_scale0_ref(pair, *, columns=None):
    """Plain twin of ``vif_scale0`` (same arguments and results)."""
    check_pair(pair)
    return vif.scale_sums(pair[0], pair[1], vif.vif_window(0), columns), _emit(pair, 1)


def vif_tail_ref(level1, *, columns=None):
    """Plain twin of ``vif_tail`` (same arguments and result)."""
    check_pair(level1)
    out, x = [], level1
    for k in range(1, vif.NUM_SCALES):
        out.append(vif.scale_sums(x[0], x[1], vif.vif_window(k), vif.scale_columns(columns, k - 1)))
        if k + 1 < vif.NUM_SCALES:
            x = _emit(x, k + 1)
    return torch.stack(out, dim=1)


def vif_blocks(h: int, w: int) -> int:
    """Partial tiles per frame of an h x w scale: its 32x8 tiles (PART_W x
    PART_H), the count of ``tm_vif_blocks`` (csrc/vif.cu)."""
    return -(-w // PART_W) * -(-h // PART_H)


def level_scratch(bsz: int, h: int, w: int, dev) -> torch.Tensor:
    """The two f32 partials of every 32x8 tile of B frames of an h x w
    scale: a scale's only scratch, since the tile kernel keeps its
    row-blurred planes (and the next scale's rows) in shared memory."""
    return torch.empty(bsz * vif_blocks(h, w) * 2, dtype=torch.float32, device=dev)


def _launch(lib, x, scale, sums, sums_pstride, nxt, columns):
    """One ``tm_vif_level`` call on the current stream, the maps of the
    scale's columns ``columns`` (None: all) summed."""
    _, bsz, h, w = x.shape
    dev = x.device
    clo, chi = vif.window_columns(columns, w)
    parts = level_scratch(bsz, h, w, dev)
    win_e = None if nxt is None else _window(scale + 1, dev).data_ptr()
    with launch_stream(dev) as stream:
        check(
            lib.tm_vif_level(
                x.data_ptr(), bsz, h, w, scale, _window(scale, dev).data_ptr(), win_e, clo, chi,
                parts.data_ptr(), sums.data_ptr(), sums_pstride, None if nxt is None else nxt.data_ptr(),
                stream,
            ),
            "tm_vif_level",
        )


def _next_level(x):
    _, bsz, h, w = x.shape
    return torch.empty((2, bsz, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=x.device)


def vif_scale0(pair: torch.Tensor, *, columns=None):
    """VIF scale 0 of a (2, B, h, w) f32 (reference, distorted) luma pair in
    8-bit units -> ((B, 2) f32 (num, den) sums over the columns ``columns``
    = (lo, hi) (None: all), the whole (2, B, ceil(h/2), ceil(w/2)) f32
    input of scale 1)."""
    check_pair(pair)
    if pair.device.type == "cpu":
        return vif_scale0_ref(pair, columns=columns)
    if pair.device.type != "cuda":
        raise ValueError(f"vif_scale0 runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    sums = torch.empty((pair.shape[1], 2), dtype=torch.float32, device=pair.device)
    level1 = _next_level(pair)
    _launch(lib, pair, 0, sums, 2, level1, columns)
    vif_scale0.launches += 1
    return sums, level1


vif_scale0.launches = 0


def vif_tail(level1: torch.Tensor, *, columns=None) -> torch.Tensor:
    """VIF scales 1-3 from scale 1's (2, B, h, w) f32 input (``vif_scale0``'s
    second result) -> (B, 3, 2) f32 (num, den) sums; ``columns``: scale 1's
    window (None: all columns), scale k's ``vif.scale_columns(columns, k -
    1)``."""
    check_pair(level1)
    if level1.device.type == "cpu":
        return vif_tail_ref(level1, columns=columns)
    if level1.device.type != "cuda":
        raise ValueError(f"vif_tail runs on cuda or cpu, not {level1.device}")
    lib = LIBRARY.get()
    nscales = vif.NUM_SCALES - 1
    sums = torch.empty((level1.shape[1], nscales, 2), dtype=torch.float32, device=level1.device)
    x = level1
    for k in range(1, vif.NUM_SCALES):
        nxt = _next_level(x) if k + 1 < vif.NUM_SCALES else None
        _launch(lib, x, k, sums[:, k - 1], nscales * 2, nxt, vif.scale_columns(columns, k - 1))
        x = nxt
    vif_tail.launches += 1
    return sums


vif_tail.launches = 0


def vif_scale_stats(pair: torch.Tensor, *, columns=None) -> torch.Tensor:
    """All four scales' (num, den) sums of a (2, B, h, w) f32 pair -> (B, 4,
    2) f32, through #14 and #15 (their twins on the CPU); ``columns``: the
    owned level-0 columns (module docstring; None: all)."""
    sums0, level1 = vif_scale0(pair, columns=columns)
    return torch.cat([sums0[:, None], vif_tail(level1, columns=vif.scale_columns(columns, 1))], dim=1)


def vif_width_sharded(fn, mesh, *, in_ndims):
    """``vif_scale_stats``, the fixed-point ``integer_vif_stats``
    (ops/kernels/integer_vif.py, whose docstring derives the same plan) or
    the plain entry ops/vif.py ``vif_scale_stats`` with one frame's columns
    split over ``mesh`` (module docstring; ``shard_over_width`` calls this).
    ``fn``: one of them, bare or through functools.partial
    (``integer_vif_stats`` with its keyword ``depth``, the plain entry with
    ``backend``, ``integer`` and ``depth``, this module's
    ``vif_scale_stats`` with none); its input the (2, B, h, w) pair (f32,
    or the luma codes, whose dtype each strip keeps), ``in_ndims`` (4,), or
    for the plain entry (B, h, w) ``ref`` and ``dis``, ``in_ndims`` (3, 3),
    each strip routed by the entry itself (#14 / #15, K-int-VIF or the
    plain versions).  Each call plans the strips (``spatial_sharding``:
    owned edges on multiples of 8, a halo of 24 columns), and each strip,
    under its device and its stream (``launch_shards``), cuts its columns
    of the inputs (``strip_input``) and sums its owned window; the strips'
    (B, 4, 2) sums add in f64 on ``mesh.devices[0]`` and round once to f32.
    ``ValueError`` where a strip would own fewer than 8 columns.  A mesh of
    one runs ``fn`` unchanged on its device."""
    # Imported here: that module imports this one.
    from turbo_metrics_tpu_torch.ops import routes
    from turbo_metrics_tpu_torch.ops.kernels.integer_vif import integer_vif_stats

    base, kw = partial_keywords(fn)
    entries = {vif_scale_stats: ((4,), set()), integer_vif_stats: ((4,), {"depth"}),
               vif.vif_scale_stats: ((3, 3), {"backend", "integer", "depth"})}
    if base not in entries:
        raise TypeError("vif_width_sharded takes ops.kernels.vif.vif_scale_stats, "
                        f"ops.kernels.integer_vif.integer_vif_stats or ops.vif.vif_scale_stats, not {fn!r}")
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
        plan = spatial_sharding(mesh, args[0].shape[-1], alignment=STRIP_ALIGNMENT, halo=STRIP_HALO)
        outs = launch_shards(
            lambda k, dev: base(*(strip_input(a, plan[k], dev) for a in args), columns=plan[k].columns, **kw), mesh)
        return add_strips(outs, dest).float()

    return sharded
