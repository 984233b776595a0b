"""Kernels #16 and #17: VMAF motion's integer blur, with the row SADs.

``motion_stats`` launches ``tm_motion_stats`` and ``integer_blur`` launches
``tm_integer_blur`` (csrc/motion.cu) on a CUDA tensor; on a CPU tensor each
runs its plain twin (``motion_stats_ref``, ``integer_blur_ref``).  They
replace the JAX package's ``motion_stats_pallas`` and ``integer_blur_pallas``
(turbo_metrics_tpu/ops/pallas/motion.py:180 and :236), whose jnp
counterparts the JAX engine runs: the batch's blur and SAD once per batch,
the blur alone for the first frame of a stream.

Frame b's previous blurred frame is the blur of frame b - 1 of the same
batch; frame 0's is ``prev0``, the plane carried over from the previous
batch (the JAX engine concatenates the same planes).  In place of
``prev0``, ``prev`` gives every frame its own previous blurred plane (the
JAX package's per-frame ``prev_blurred``, which ops/vmaf_motion.py
``motion_stats`` takes), read by the same one launch.

``columns=(lo, hi)`` (``motion_stats``): the owned columns whose SADs are
summed (None: all of them); the blurred planes are written whole.

Width sharding (``motion_width_sharded``; parallel/mesh.py
``shard_over_width`` calls it, for ``motion_stats`` and ``integer_blur``):
each strip of the frame's columns, and of ``prev0``, is cut once, at upload,
with owned edges on multiples of A = 16 and a halo of H = 16 columns on each
side (clipped at the frame's edges).  Why these:
  * H: the 5-tap blur reaches 2 columns on each side, so every owned
    column's blur reads the frame's own samples, and a strip's edge at the
    frame's edge mirrors as the frame does; H is that rounded up to A;
  * A: 16 keeps every interior strip's rows whole 16-byte chunks at u8
    (its width and its first column multiples of 16), the lane unit of
    ``motion_kernel`` (csrc/motion.cu); u16 and int32 rows are then whole
    chunks too;
  * the strips' owned columns of the blurred planes are joined on the first
    device, bit for bit the frame's, and their row SADs (each the uint32
    sum of its owned columns) add in int64.  That is the frame row's uint32
    sum exactly while no row sum wraps: w * (2^16 - 1) < 2^32, every width
    below 65537.
The halo costs (w + 2 H (n - 1)) / w of the columns: 1.00417, 1.0125 and
1.02917 over 2, 4 and 8 strips at 7680 columns.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import vmaf_motion
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
# The luma types of csrc/motion.cu are those of csrc/xpsnr.cu.
from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES
from turbo_metrics_tpu_torch.parallel.mesh import (
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    to_dest,
    upload,
)

# The strips of a width-sharded call (module docstring).
STRIP_ALIGNMENT = 16
STRIP_HALO = 16


def _check(y, depth):
    if y.ndim != 3 or min(y.shape[-2:]) < 3:
        raise ValueError(f"y must be (B, h, w) with h, w >= 3, got {tuple(y.shape)}")
    if y.dtype not in DTYPE_CODES:
        raise ValueError(f"y must be uint8, uint16 or int32, got {y.dtype}")
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be 1-16 bits, got {depth}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")


def _check_prev(y, prev0, prev):
    """Exactly one of ``prev0``, a contiguous (h, w) uint16 plane, and
    ``prev``, (B, h, w) uint16 planes each contiguous (any batch stride,
    0 included: one plane for every frame), on y's device."""
    if (prev0 is None) == (prev is None):
        raise ValueError("give exactly one of prev0 and prev")
    name, p, shape = ("prev0", prev0, y.shape[1:]) if prev is None else ("prev", prev, y.shape)
    if p.shape != shape or p.dtype != torch.uint16:
        raise ValueError(f"{name} must be {tuple(shape)} uint16, got {tuple(p.shape)} {p.dtype}")
    h, w = y.shape[-2:]
    if p.device != y.device or p.stride()[-2:] != (w, 1) or (prev is not None and p.stride(0) < 0):
        raise ValueError(f"{name} must hold contiguous planes, on y's device")


def _device(y, name):
    if y.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {y.device}")


def integer_blur_ref(y, *, depth=8):
    """Plain twin of ``integer_blur`` (same arguments and result)."""
    _check(y, depth)
    return vmaf_motion.integer_blur(y, depth=depth, backend="jnp")


def integer_blur(y: torch.Tensor, *, depth: int = 8) -> torch.Tensor:
    """The exact integer 5-tap blur of (B, h, w) luma at ``depth`` bits ->
    (B, h, w) uint16."""
    _check(y, depth)
    if y.device.type == "cpu":
        return integer_blur_ref(y, depth=depth)
    _device(y, "integer_blur")
    lib = LIBRARY.get()
    bsz, h, w = y.shape
    blurred = torch.empty((bsz, h, w), dtype=torch.uint16, device=y.device)
    with launch_stream(y.device) as stream:
        check(
            lib.tm_integer_blur(y.data_ptr(), DTYPE_CODES[y.dtype], bsz, h, w, depth,
                                blurred.data_ptr(), stream),
            "tm_integer_blur",
        )
    integer_blur.launches += 1
    return blurred


integer_blur.launches = 0


def motion_stats_ref(y, prev0=None, *, prev=None, depth=8, columns=None):
    """Plain twin of ``motion_stats`` (same arguments and results)."""
    _check(y, depth)
    _check_prev(y, prev0, prev)
    blurred = vmaf_motion.integer_blur(y, depth=depth, backend="jnp")
    if prev is None:
        # In int64: torch's uint16 tensors take few operations on CUDA.
        prev = torch.cat([prev0[None].to(torch.int64), blurred[:-1].to(torch.int64)])
    return {"blurred": blurred, "sad_rows": vmaf_motion.sad_rows(blurred, prev, columns)}


def motion_stats(y: torch.Tensor, prev0: torch.Tensor | None = None, *, prev: torch.Tensor | None = None,
                 depth: int = 8, columns=None) -> dict:
    """Blur each frame of (B, h, w) luma and SAD it against the previous
    blurred frame: frame b - 1's, and ``prev0``, a (h, w) uint16 plane, for
    frame 0; or in place of ``prev0`` ``prev``, (B, h, w) uint16, each
    frame's own (exactly one of the two).  Returns {'blurred': (B, h, w)
    uint16, 'sad_rows': (B, h) int64 holding the uint32 row sums of the
    columns ``columns`` = (lo, hi) (None: the whole rows)}."""
    _check(y, depth)
    _check_prev(y, prev0, prev)
    clo, chi = vmaf_motion.sad_window(columns, y.shape[-1])
    if y.device.type == "cpu":
        return motion_stats_ref(y, prev0, prev=prev, depth=depth, columns=columns)
    _device(y, "motion_stats")
    lib = LIBRARY.get()
    bsz, h, w = y.shape
    blurred = torch.empty((bsz, h, w), dtype=torch.uint16, device=y.device)
    sad_rows = torch.empty((bsz, h), dtype=torch.int64, device=y.device)
    with launch_stream(y.device) as stream:
        check(
            lib.tm_motion_stats(y.data_ptr(), DTYPE_CODES[y.dtype], None if prev0 is None else prev0.data_ptr(),
                                None if prev is None else prev.data_ptr(), 0 if prev is None else prev.stride(0),
                                bsz, h, w, depth, clo, chi, blurred.data_ptr(), sad_rows.data_ptr(), stream),
            "tm_motion_stats",
        )
    motion_stats.launches += 1
    return {"blurred": blurred, "sad_rows": sad_rows}


motion_stats.launches = 0


def motion_width_sharded(fn, mesh, *, in_ndims):
    """``motion_stats`` or ``integer_blur``, of this module or the plain
    entries of ops/vmaf_motion.py, with one frame's columns split over
    ``mesh`` (module docstring; ``shard_over_width`` calls this).  ``fn``:
    one of them, bare or through functools.partial with ``depth`` (and, for
    the plain entries, ``backend``); its inputs the (B, h, w) luma and, for
    ``motion_stats``, the (h, w) uint16 ``prev0`` (``in_ndims`` (3, 2)) or
    for the plain entry ``prev_blurred``, per frame or one plane, cut like
    the luma (``in_ndims`` (3, 3) or (3, 2)); ``integer_blur`` (3,).  Each
    call plans the strips (``spatial_sharding``: owned edges on multiples of
    16, a halo of 16 columns), and each strip, under its device and its
    stream (``launch_shards``), cuts its columns of every input
    (``strip_input``) and runs the entry (the plain ones by their own
    route: #16 / #17 or the plain versions), the SADs over its owned
    columns; the owned columns of the blurred planes are joined and the row
    SADs added in int64 on ``mesh.devices[0]``, the unsharded call's
    results bit for bit.  ``ValueError`` where a strip would own fewer than
    16 columns.  A mesh of one runs ``fn`` unchanged on its device."""
    from turbo_metrics_tpu_torch.ops import routes

    base, kw = partial_keywords(fn)
    entries = {motion_stats: ({(3, 2)}, {"depth"}), integer_blur: ({(3,)}, {"depth"}),
               vmaf_motion.motion_stats: ({(3, 3), (3, 2)}, {"depth", "backend"}),
               vmaf_motion.integer_blur: ({(3,)}, {"depth", "backend"})}
    if base not in entries:
        raise TypeError("motion_width_sharded takes ops.kernels.motion.motion_stats or integer_blur, or "
                        f"ops.vmaf_motion.motion_stats or integer_blur, not {fn!r}")
    ndims, keywords = entries[base]
    if tuple(in_ndims) not in ndims:
        raise ValueError(f"{fn!r} takes inputs of {' or '.join(map(str, sorted(ndims)))} dims, "
                         f"got in_ndims={tuple(in_ndims)}")
    unknown = set(kw) - keywords
    if unknown:
        raise TypeError(f"{base.__name__} takes no keywords {sorted(unknown)} under width sharding")
    blur_only = base in (integer_blur, vmaf_motion.integer_blur)
    dest = mesh.devices[0]
    routes.kernel_route(kw.get("backend"), dest)  # an unknown backend name raises here

    def sharded(*args):
        check_inputs(args, in_ndims)
        if mesh.size == 1:
            return fn(*(upload(a, dest) for a in args))
        plan = spatial_sharding(mesh, args[0].shape[-1], alignment=STRIP_ALIGNMENT, halo=STRIP_HALO)

        def strip(k, dev):
            s = plan[k]
            cut = [strip_input(a, s, dev) for a in args]
            if blur_only:
                return base(*cut, **kw)[..., s.own_lo:s.own_hi]
            out = base(*cut, **kw, columns=s.columns)
            return out["blurred"][..., s.own_lo:s.own_hi], out["sad_rows"]

        outs = launch_shards(strip, mesh)
        if blur_only:
            return torch.cat([to_dest(o, dest) for o in outs], dim=-1)
        sad = None
        for _, rows in outs:
            rows = to_dest(rows, dest)
            sad = rows if sad is None else sad + rows
        return {"blurred": torch.cat([to_dest(b, dest) for b, _ in outs], dim=-1), "sad_rows": sad}

    return sharded
