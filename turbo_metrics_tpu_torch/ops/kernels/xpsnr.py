"""Kernel #13: XPSNR block statistics of a batch of luma planes.

``xpsnr_block_stats`` launches ``tm_xpsnr_block_stats`` (csrc/xpsnr.cu) on a
CUDA tensor and runs its plain twin ``xpsnr_block_stats_ref`` on a CPU
tensor.  It replaces the JAX package's ``xpsnr_block_stats_pallas``
(turbo_metrics_tpu/ops/pallas/xpsnr.py:197), reached there through
``ops/xpsnr_ops.xpsnr_block_stats``.

The previous reference frame of frame b is reference frame b - 1 of the same
batch; frame 0's is ``prev0``, the last reference luma of the previous batch
(or frame 0 itself at the start of a stream, so its temporal activity is 0).
The JAX engine uploads the same frames as a third batch of planes.  In
place of ``prev0``, ``prev`` gives every frame its own previous plane (the
JAX package's ``y_prev``, which ops/xpsnr_ops.py ``xpsnr_block_stats`` takes),
read by the same one launch.  The
distorted luma is brought to the reference's depth by ``dis_shift`` bits
(``xpsnr_ops.align_luma_depth``) inside the kernel.

``xpsnr_width_sharded`` (parallel/mesh.py ``shard_over_width``) splits a
frame's columns into strips whose owned edges sit on multiples of the
16-column block, each cut with one whole block of halo on either side:
every strip runs the kernel unchanged on its columns, its block grid is the
frame's, and its owned blocks' highpass reads real neighbours, so its owned
block columns are the frame's bit for bit.  It also splits
ops/xpsnr_ops.py's ``xpsnr_block_stats``, whose ``y_prev`` the same plan
cuts.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import xpsnr_ops
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.parallel.mesh import (
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    to_dest,
    upload,
)

# Luma types the kernel takes: u8 / u16 decoded planes, int32 luma codes of
# RGB sources.
DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
QUANTITIES = ("sse", "sact", "tact")


def _check(y_ref, y_dis, prev0, dis_shift, prev=None):
    if y_ref.ndim != 3 or y_dis.shape != y_ref.shape:
        raise ValueError(
            f"y_ref and y_dis must be one (B, h, w) shape, got {tuple(y_ref.shape)} "
            f"and {tuple(y_dis.shape)}"
        )
    if (prev0 is None) == (prev is None):
        raise ValueError("give exactly one of prev0 (frame 0's previous plane) and prev (every frame's)")
    name, p, shape = ("prev0", prev0, y_ref.shape[1:]) if prev is None else ("prev", prev, y_ref.shape)
    if p.shape != shape or p.dtype != y_ref.dtype:
        raise ValueError(f"{name} must be {tuple(shape)} of {y_ref.dtype}, got {tuple(p.shape)} {p.dtype}")
    for what, t in (("y_ref", y_ref), ("y_dis", y_dis)):
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{what} must be uint8, uint16 or int32, got {t.dtype}")
    if not y_ref.device == y_dis.device == p.device:
        raise ValueError(f"y_ref, y_dis and {name} must be on one device")
    if not (y_ref.is_contiguous() and y_dis.is_contiguous() and p.is_contiguous()):
        raise ValueError(f"y_ref, y_dis and {name} must be contiguous")
    if not -16 <= dis_shift <= 16:
        raise ValueError(f"dis_shift must be within 16 bits, got {dis_shift}")


def xpsnr_block_stats_ref(y_ref, y_dis, prev0=None, *, prev=None, dis_shift=0):
    """Plain twin of ``xpsnr_block_stats`` (same arguments and results)."""
    _check(y_ref, y_dis, prev0, dis_shift, prev)
    # In int64: torch's uint16 tensors take few operations on CUDA.
    if prev is None:
        prev = torch.cat([prev0[None].to(torch.int64), y_ref[:-1].to(torch.int64)])
    # A shift of s bits is the alignment from depth 0 to depth s.
    y_dis = xpsnr_ops.align_luma_depth(y_dis, 0, dis_shift)
    return xpsnr_ops.xpsnr_block_stats(y_ref, y_dis, prev, backend="jnp")


def xpsnr_block_stats(
    y_ref: torch.Tensor,
    y_dis: torch.Tensor,
    prev0: torch.Tensor | None = None,
    *,
    prev: torch.Tensor | None = None,
    dis_shift: int = 0,
) -> dict[str, torch.Tensor]:
    """Per 16x16 block of each frame: the SSE, spatial and temporal activity.

    ``y_ref``, ``y_dis``: (B, h, w) luma, uint8, uint16 or int32 (the two
    may differ); ``prev0``: (h, w) the previous reference luma of frame 0,
    of ``y_ref``'s type, or in its place ``prev``: (B, h, w) each frame's
    previous reference luma (exactly one of the two).  Returns {"sse",
    "sact", "tact"}: (B, ceil(h/16), ceil(w/16)) int64 tensors holding the
    uint32 grids (mod 2^32).
    """
    _check(y_ref, y_dis, prev0, dis_shift, prev)
    if y_ref.device.type == "cpu":
        return xpsnr_block_stats_ref(y_ref, y_dis, prev0, prev=prev, dis_shift=dis_shift)
    if y_ref.device.type != "cuda":
        raise ValueError(f"xpsnr_block_stats runs on cuda or cpu, not {y_ref.device}")
    lib = LIBRARY.get()
    bsz, h, w = y_ref.shape
    hb, wb = -(-h // xpsnr_ops.BLOCK), -(-w // xpsnr_ops.BLOCK)
    out = torch.empty((3, bsz, hb, wb), dtype=torch.int64, device=y_ref.device)
    with launch_stream(y_ref.device) as stream:
        check(
            lib.tm_xpsnr_block_stats(
                y_ref.data_ptr(), DTYPE_CODES[y_ref.dtype], y_dis.data_ptr(),
                DTYPE_CODES[y_dis.dtype], None if prev0 is None else prev0.data_ptr(),
                None if prev is None else prev.data_ptr(), h * w, bsz, h, w, int(dis_shift),
                out.data_ptr(), stream,
            ),
            "tm_xpsnr_block_stats",
        )
    xpsnr_block_stats.launches += 1
    return dict(zip(QUANTITIES, out.unbind(0)))


xpsnr_block_stats.launches = 0


def xpsnr_width_sharded(fn, mesh, *, in_ndims):
    """``xpsnr_block_stats`` with one frame's columns split over ``mesh``
    (module docstring; ``shard_over_width`` calls this).  ``fn``:
    ``xpsnr_block_stats``, bare or through functools.partial with
    ``dis_shift``, its inputs (B, h, w) ``y_ref`` and ``y_dis`` and (h, w)
    ``prev0``, ``in_ndims`` (3, 3, 2); or ops/xpsnr_ops.py's
    ``xpsnr_block_stats`` with ``block`` (16 only), ``depth`` and
    ``backend``, its inputs (B, h, w) ``y_ref``, ``y_dis`` and ``y_prev``,
    ``in_ndims`` (3, 3, 3).  Each call plans the strips
    (``spatial_sharding``: owned edges on multiples of 16, a halo of 16
    columns), and each strip, under its device and its stream
    (``launch_shards``), cuts its columns of the three inputs
    (``strip_input``), runs the kernel on them and keeps its owned block
    columns; these are joined on ``mesh.devices[0]`` into the unsharded
    call's grids, bit for bit.  ``ValueError`` where a strip would own
    fewer than 16 columns.  A mesh of one runs ``fn`` unchanged on its
    device."""
    base, kw = partial_keywords(fn)
    entries = {xpsnr_block_stats: ((3, 3, 2), {"dis_shift"}),
               xpsnr_ops.xpsnr_block_stats: ((3, 3, 3), {"block", "depth", "backend"})}
    if base not in entries:
        raise TypeError("xpsnr_width_sharded takes ops.kernels.xpsnr.xpsnr_block_stats or "
                        f"ops.xpsnr_ops.xpsnr_block_stats, not {fn!r}")
    ndims, keywords = entries[base]
    if tuple(in_ndims) != ndims:
        raise ValueError(f"{fn!r} takes inputs of {ndims} dims, got in_ndims={tuple(in_ndims)}")
    unknown = set(kw) - keywords
    if unknown:
        raise TypeError(f"xpsnr_block_stats takes no keywords {sorted(unknown)}")
    block = xpsnr_ops.BLOCK
    if kw.get("block", block) != block:
        raise ValueError(f"width sharding of xpsnr_block_stats takes block={block} only (its strips' "
                         f"alignment), got block={kw['block']}")
    dest = mesh.devices[0]

    def sharded(*args):
        check_inputs(args, in_ndims)
        if mesh.size == 1:
            return fn(*(upload(a, dest) for a in args))
        plan = spatial_sharding(mesh, args[0].shape[-1], alignment=block, halo=block)

        def strip_grids(k, dev):
            s = plan[k]
            grids = base(*(strip_input(a, s, dev) for a in args), **kw)
            return [grids[q][..., s.own_lo // block:-(-s.own_hi // block)] for q in QUANTITIES]

        outs = launch_shards(strip_grids, mesh)
        return {q: torch.cat([to_dest(o[i], dest) for o in outs], dim=-1) for i, q in enumerate(QUANTITIES)}

    return sharded
