"""Frame data parallelism over a mesh of devices.

The workload is embarrassingly parallel over frame pairs (SURVEY.md section
5: the reference has no cross-device sharding; its unit of concurrency is
the frame).  A mesh is an ordered tuple of devices along one axis; a batch
of frames splits into equal leading-dim chunks, one per device, each shard
runs on its own device under its own CUDA stream, and per-frame results
gather back in frame order.  There are no collectives: the one edge between
shards (VMAF motion's previous blurred frame, XPSNR's previous reference
frame) is carried by uploading the previous shard's last reference frame
once more to the next shard's device (engine.TurboMetrics).

A mesh may repeat a device.  On the CPU repeats take the place of the JAX
package's virtual host devices; on one card two shards on ``cuda:0`` run on
two streams of it.

Width sharding (``spatial_sharding``, ``split_columns``, ``shard_over_width``:
the JAX package's counterparts split one frame's columns over the devices)
is written into each metric's kernels, since PyTorch has no SPMD
partitioner to insert the halo exchanges into any function.  This module
plans and cuts the strips; ``shard_over_width`` hands an entry to its
metric's own strip loop: models/ssimulacra2.py ``subscores_width_sharded``
(SSIMULACRA2), ops/quality.py ``quality_width_sharded`` (PSNR, SSIM and
MS-SSIM from a linear-RGB pair) and ``plain_width_sharded`` (SSIM and
MS-SSIM on code values), ops/kernels/xpsnr.py ``xpsnr_width_sharded``
(XPSNR's block grids), and VMAF's features: ops/kernels/vif.py
``vif_width_sharded`` and ops/kernels/adm.py ``adm_width_sharded`` (the
float features and the fixed-point ones of ops/kernels/integer_vif.py and
integer_adm.py) and ops/kernels/motion.py ``motion_width_sharded`` (the
motion SADs and the blur; each module's docstring derives its plan).
Each strip is cut once, at
upload, with a halo wide enough for every level, and nothing passes between
devices until the strips' results are joined on ``mesh.devices[0]``:
  * the strips' owned edges sit on multiples of an alignment A, and a halo
    of H columns on each side (clipped at the frame's edges) leaves every
    owned output reading the frame's own samples;
  * SSIMULACRA2 and the SSIM family with S levels take A = 2^(S-1), so every
    2x2 quad of every level inside a strip is the frame's quad and every
    level's values in the strip equal the frame's, bit for bit (kernel 1
    takes one chroma pair per quad: A >= 2 with chroma), and H = 5 *
    2^(S-1): the 11-tap windows reach 5 columns on every level;
  * the level kernels sum only the owned window (``columns=``), and the
    strips' sums add in f64 (``add_strips``); only the grouping of the
    sums changes.  PSNR's squared differences are exact integers, so its
    strips add to the frame's sum bit for bit;
  * XPSNR takes A = H = 16, its block: each strip's block grid is the
    frame's, its owned blocks' 3x3 highpass reads real neighbours, and the
    owned block columns are joined;
  * VIF takes A = 8 (four scales) and H = 24, ADM A = 16 (four DWT levels)
    and H = 32, their f32 sums adding in f64, at float and at fixed-point
    conventions alike; motion and its blur A = 16,
    H = 16, the owned columns of the blurred planes joined and the row
    SADs added in int64.
The halo costs (w + 2 H (n - 1)) / w of the columns: 1.042 over 2 strips
and 1.125 over 4 at 7680 columns with six levels.  A per-level exchange of
5-column halos between devices would break kernel 2 and #4, which run
several levels in one launch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

FRAME_AXIS = "frames"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis (repeats allowed)."""

    devices: tuple
    axis: str = FRAME_AXIS
    # One CUDA stream per shard, made at first use (``shard_streams``).
    _streams: list = field(default_factory=list, init=False, compare=False, repr=False)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
            raise ValueError(f"a mesh's devices are all cuda or all cpu, got {devs}")
        if devs[0].type == "cuda":
            devs = tuple(torch.device("cuda", d.index or 0) for d in devs)
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> tuple:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def shard_streams(self) -> list:
        """Each shard's own CUDA stream (None for every shard on the CPU)."""
        if not self._streams:
            self._streams.extend(
                torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
            )
        return self._streams


def make_mesh(n_devices: Optional[int] = None, *, device="cuda", axis: str = FRAME_AXIS) -> Mesh:
    """A mesh of ``n_devices`` devices.  ``cuda``: the cards ``cuda:0 ..
    n-1`` (every card where None); raises where CUDA is absent, and
    ``ValueError`` where there are fewer cards.  ``cuda:K``: ``n`` shards of
    card K (one where None), each on its own stream.  ``cpu``: ``n`` entries
    of ``cpu`` (one where None)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh(device={str(device)!r}) needs CUDA, which is not available")
        have = torch.cuda.device_count()
        if dev.index is None:
            n = have if n_devices is None else int(n_devices)
            if n > have:
                raise ValueError(f"requested {n} devices, have {have}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            if dev.index >= have:
                raise ValueError(f"requested {dev}, have {have} devices")
            n = 1 if n_devices is None else int(n_devices)
            devices = [dev] * n
    elif dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devices = [dev] * n
    else:
        raise ValueError(f"unsupported device {device!r}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh(tuple(devices), axis)


def frames_per_shard(n: int, mesh: Mesh) -> int:
    if n % mesh.size:
        raise ValueError(f"{n} frames do not split evenly over a mesh of {mesh.size}")
    return n // mesh.size


def upload(chunk, dev: torch.device) -> torch.Tensor:
    if isinstance(chunk, np.ndarray):
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
    return chunk.to(dev)


def split_frames(t, mesh: Mesh) -> list:
    """Equal leading-dim chunks of ``t`` (a tensor or a numpy array), chunk
    k on ``mesh.devices[k]``: the counterpart of the JAX package's
    ``frame_sharding``.  The leading dim must split evenly."""
    per = frames_per_shard(t.shape[0], mesh)
    return [upload(t[k * per:(k + 1) * per], d) for k, d in enumerate(mesh.devices)]


def launch_shards(fn: Callable, mesh: Mesh) -> list:
    """``fn(k, device)`` for every shard k, each with its device current and
    on its own stream, every shard launched before any result is read.
    Each shard stream first waits on its device's current stream (work
    queued before, such as the previous batch); after the launches each
    device's current stream waits on its shards' streams, so the results
    can be read there.  Returns the shards' results in mesh order."""
    streams = mesh.shard_streams()
    outs = []
    for k, (dev, stream) in enumerate(zip(mesh.devices, streams)):
        if stream is None:
            outs.append(fn(k, dev))
            continue
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs.append(fn(k, dev))
    for dev, stream in zip(mesh.devices, streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return outs


def _leaves(tree, path: str = "output"):
    """(path, tensor or None) of every leaf of a nest of dicts, tuples and
    lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def gather_frames(outs: Sequence, mesh: Mesh, per: int):
    """The shards' per-frame results ``outs`` (one nest each, of one
    structure) concatenated in frame order on ``mesh.devices[0]``.  Every
    tensor must lead with the shard's ``per`` frames: one that does not (a
    scalar, a reduction over the batch) raises, naming it."""
    dest = mesh.devices[0]
    shard_leaves = [list(_leaves(o)) for o in outs]
    merged = []
    for i, (path, first) in enumerate(shard_leaves[0]):
        parts = [leaves[i][1] for leaves in shard_leaves]
        if first is None:
            merged.append(None)
            continue
        for t in parts:
            if not torch.is_tensor(t) or t.ndim == 0 or t.shape[0] != per:
                shape = tuple(t.shape) if torch.is_tensor(t) else type(t).__name__
                raise ValueError(
                    f"{path} has no leading frame dim of the shard's {per} frames (got {shape}): "
                    "a sharded function returns per-frame values only"
                )
            if t.device.type == "cuda":
                # Read on the device's current stream, which the gather made
                # wait on the shard's stream: keep the memory until then.
                t.record_stream(torch.cuda.current_stream(t.device))
        merged.append(torch.cat([t.to(dest) for t in parts]))
    return _rebuild(outs[0], iter(merged))


def shard_over_frames(fn: Callable, mesh: Mesh, *, in_ndims: Sequence[int]):
    """``fn`` with every input's leading dim split over the mesh: each shard
    calls ``fn`` on its chunk of every input (uploaded to its device under
    its stream), and the per-frame outputs come back concatenated on
    ``mesh.devices[0]`` in frame order (``gather_frames``).  ``in_ndims``:
    the number of dims of each input, checked on every call."""

    def sharded(*args):
        if len(args) != len(in_ndims):
            raise ValueError(f"expected {len(in_ndims)} inputs, got {len(args)}")
        for i, (a, nd) in enumerate(zip(args, in_ndims)):
            if a.ndim != nd:
                raise ValueError(f"input {i} has {a.ndim} dims, expected {nd}")
        n = args[0].shape[0]
        if any(a.shape[0] != n for a in args):
            raise ValueError(f"inputs differ in their leading dim: {[a.shape[0] for a in args]}")
        per = frames_per_shard(n, mesh)
        outs = launch_shards(
            lambda k, dev: fn(*(upload(a[k * per:(k + 1) * per], dev) for a in args)), mesh
        )
        return gather_frames(outs, mesh, per)

    return sharded


def pad_batch_to_mesh(arr: np.ndarray, mesh: Mesh) -> tuple[np.ndarray, int]:
    """Pad the batch dim to a multiple of the mesh size (repeat last frame).

    Returns (padded, original_length).
    """
    n = arr.shape[0]
    pad = (-n) % mesh.size
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
    return arr, n


# ---------------------------------------------------------------------------
# Width sharding: one frame's columns over the mesh (module docstring).
# ---------------------------------------------------------------------------

RADIUS = 5  # the SSIMULACRA2 blur's radius (ops/gaussian.py RADIUS)


class Strip(NamedTuple):
    """One strip of a frame's columns: ``lo``/``hi`` its level-0 columns of
    the frame, halo included; ``own_lo``/``own_hi`` the window of columns
    it owns, strip-local (columns ``lo + own_lo`` .. ``lo + own_hi`` of the
    frame)."""

    lo: int
    hi: int
    own_lo: int
    own_hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def columns(self) -> tuple:
        return self.own_lo, self.own_hi


def strip_alignment(num_scales: int, chroma: bool = False) -> int:
    """A = 2^(S-1): the multiple that every owned edge and every cut sits on,
    at least 2 for 4:2:0 chroma (whole chroma samples)."""
    a = 1 << max(int(num_scales) - 1, 0)
    return max(a, 2) if chroma else a


def strip_halo(num_scales: int, chroma: bool = False) -> int:
    """H: the halo of level-0 columns on each side of a strip, 5 * 2^(S-1)
    rounded up to the alignment (it is a multiple of it but at one level
    with chroma, 6 there)."""
    a = strip_alignment(num_scales, chroma)
    return -(-RADIUS * (1 << max(int(num_scales) - 1, 0)) // a) * a


def spatial_sharding(
    mesh: Mesh, w: int, *, num_scales: int = 1, chroma: bool = False, alignment=None, halo=None
) -> tuple:
    """The column strips of a w wide frame over ``mesh``, one ``Strip`` per
    mesh entry (the counterpart of the JAX package's ``spatial_sharding``).
    The owned widths are as even as the alignment A allows, each a multiple
    of A but the last, which ends at ``w`` (odd widths included); each
    strip's cut adds ``halo`` columns on either side, clipped at the frame's
    edges.  A and the halo are ``strip_alignment`` and ``strip_halo`` of
    ``num_scales`` levels unless ``alignment`` / ``halo`` give them (the
    halo a multiple of A).  ``ValueError`` where a strip would own fewer
    than A columns."""
    n = mesh.size
    a = strip_alignment(num_scales, chroma) if alignment is None else int(alignment)
    halo = strip_halo(num_scales, chroma) if halo is None else int(halo)
    if a < 1 or halo < 0 or halo % a:
        raise ValueError(f"the halo ({halo}) must be a non-negative multiple of the alignment ({a} >= 1)")
    if num_scales < 1 or w < n * a:
        raise ValueError(
            f"a {w}-column frame does not split over {n} strips: each strip owns at least {a} columns "
            f"(owned edges on multiples of {a}), so the width must be at least {n * a}"
        )
    units, rem = divmod(w // a, n)
    edges = [0]
    for k in range(n):
        edges.append(edges[-1] + a * (units + (k < rem)))
    edges[-1] = w
    plan = []
    for own_lo, own_hi in zip(edges, edges[1:]):
        lo, hi = max(0, own_lo - halo), min(w, own_hi + halo)
        plan.append(Strip(lo, hi, own_lo - lo, own_hi - lo))
    return tuple(plan)


def halo_overhead(plan: Sequence[Strip]) -> float:
    """The columns that the strips hold over the frame's own."""
    return sum(s.width for s in plan) / plan[-1].hi


def _columns(t, strip: Strip, chroma: bool):
    """Strip ``strip``'s columns of ``t`` (a tensor or a numpy array), a
    view: the last dim's [lo, hi), or for 4:2:0 chroma (..., cw, 2) the
    chroma columns [lo/2, ceil(hi/2))."""
    if chroma:
        return t[..., strip.lo // 2:(strip.hi + 1) // 2, :]
    return t[..., strip.lo:strip.hi]


def _cut(t, strip: Strip, chroma: bool):
    """``_columns``, contiguous."""
    part = _columns(t, strip, chroma)
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    return part.contiguous()


def split_columns(t, plan: Sequence[Strip], mesh: Mesh, *, chroma: bool = False) -> list:
    """Strip k's columns of every plane of ``t`` on ``mesh.devices[k]``, each
    a contiguous copy (``chroma``: a (2, B, ch, cw, 2) 4:2:0 chroma tensor,
    cut at [lo/2, ceil(hi/2))).  The copies come from ``t`` itself: nothing
    passes between the strips' devices."""
    return [upload(_cut(t, s, chroma), d) for s, d in zip(plan, mesh.devices)]


def strip_input(t, strip: Strip, dev, *, chroma: bool = False, view: bool = False):
    """Strip ``strip``'s columns of one input on ``dev``: with ``view``, a
    view where ``t`` already lies there; else ``split_columns``' contiguous
    cut, uploaded there."""
    if view and isinstance(t, torch.Tensor) and t.device == dev:
        return _columns(t, strip, chroma)
    return upload(_cut(t, strip, chroma), dev)


def partial_keywords(fn: Callable) -> tuple:
    """(the function under ``fn``'s functools.partial layers, their
    keywords): ``TypeError`` where a layer binds a positional argument, since
    a width-sharded function's arguments are the frame's inputs."""
    base, kw = fn, {}
    while isinstance(base, functools.partial):
        if base.args:
            raise TypeError("width sharding takes functools.partial with keywords only: "
                            "the frame's inputs are the sharded function's arguments")
        kw = {**base.keywords, **kw}
        base = base.func
    return base, kw


def check_inputs(args: Sequence, in_ndims: Sequence[int]) -> None:
    """``ValueError`` unless there are ``len(in_ndims)`` inputs of those
    numbers of dims."""
    if len(args) != len(in_ndims):
        raise ValueError(f"expected {len(in_ndims)} inputs, got {len(args)}")
    for i, (a, nd) in enumerate(zip(args, in_ndims)):
        if a.ndim != nd:
            raise ValueError(f"input {i} has {a.ndim} dims, expected {nd}")


def to_dest(t: torch.Tensor, dest, dtype=None) -> torch.Tensor:
    """A strip's result ``t`` on ``dest`` (as ``dtype``).  The copy is read
    on the device's current stream, which ``launch_shards`` made wait on
    the strip's stream: the strip's memory is kept until then."""
    if t.device.type == "cuda":
        t.record_stream(torch.cuda.current_stream(t.device))
    return t.to(dest, dtype)


def add_strips(outs: Sequence, dest):
    """The strips' sums ``outs`` (one nest of tensors each, of one
    structure) added in f64 on ``dest``, strip by strip in mesh order."""
    shard_leaves = [list(_leaves(o)) for o in outs]
    merged = []
    for i in range(len(shard_leaves[0])):
        total = None
        for leaves in shard_leaves:
            t = to_dest(leaves[i][1], dest, torch.float64)
            total = t if total is None else total + t
        merged.append(total)
    return _rebuild(outs[0], iter(merged))


def shard_over_width(fn: Callable, mesh: Mesh, *, in_ndims: Sequence[int]):
    """``fn`` with one frame's columns split over the mesh (module
    docstring), bare or through functools.partial with keywords only.
    ``fn`` is one of the entries whose kernels take an owned-column window,
    run by its metric's own strip loop:
      * models/ssimulacra2.py ``ssimulacra2_subscores`` and
        ``ssimulacra2_subscores_from_yuv`` (``subscores_width_sharded``);
      * ops/quality.py ``quality_from_rgb`` (``quality_width_sharded``) and
        ``ssim``, ``msssim`` and ``ssim_msssim`` (``plain_width_sharded``);
      * ops/kernels/xpsnr.py ``xpsnr_block_stats`` and ops/xpsnr_ops.py
        ``xpsnr_block_stats`` (``xpsnr_width_sharded``);
      * ops/kernels/vif.py ``vif_scale_stats``, ops/kernels/integer_vif.py
        ``integer_vif_stats`` and ops/vif.py ``vif_scale_stats``
        (``vif_width_sharded``);
      * ops/kernels/adm.py ``adm_stats``, ops/kernels/integer_adm.py
        ``integer_adm_stats`` and ops/adm.py ``adm_stats``
        (``adm_width_sharded``);
      * ``motion_stats`` and ``integer_blur`` of ops/kernels/motion.py and
        of ops/vmaf_motion.py (``motion_width_sharded``).
    Any other function raises ``TypeError``: the port has no partitioner,
    and the functions under these entries (VIF's scale wrappers
    ``vif_scale0`` and ``vif_tail``, whose windows a caller would have to
    chain by hand, the plain ``block_sums`` and the like) have no strip loop
    of their own."""
    from turbo_metrics_tpu_torch.models import ssimulacra2
    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import quality, vmaf_motion, xpsnr_ops
    from turbo_metrics_tpu_torch.ops import vif as vif_ops
    from turbo_metrics_tpu_torch.ops.kernels import adm, integer_adm, integer_vif, motion, vif, xpsnr

    base, _ = partial_keywords(fn)
    for entries, sharded in (
        ((ssimulacra2.ssimulacra2_subscores, ssimulacra2.ssimulacra2_subscores_from_yuv),
         ssimulacra2.subscores_width_sharded),
        ((quality.quality_from_rgb,), quality.quality_width_sharded),
        ((quality.ssim, quality.msssim, quality.ssim_msssim), quality.plain_width_sharded),
        ((xpsnr.xpsnr_block_stats, xpsnr_ops.xpsnr_block_stats), xpsnr.xpsnr_width_sharded),
        ((vif.vif_scale_stats, integer_vif.integer_vif_stats, vif_ops.vif_scale_stats), vif.vif_width_sharded),
        ((adm.adm_stats, integer_adm.integer_adm_stats, adm_ops.adm_stats), adm.adm_width_sharded),
        ((motion.motion_stats, motion.integer_blur, vmaf_motion.motion_stats, vmaf_motion.integer_blur),
         motion.motion_width_sharded),
    ):
        if any(base is e for e in entries):
            return sharded(fn, mesh, in_ndims=in_ndims)
    raise TypeError(
        "width sharding supports models.ssimulacra2.ssimulacra2_subscores and "
        "ssimulacra2_subscores_from_yuv, ops.quality.quality_from_rgb, ssim, msssim and ssim_msssim, "
        "xpsnr_block_stats of ops.kernels.xpsnr and ops.xpsnr_ops, vif_scale_stats of ops.kernels.vif and "
        "ops.vif, ops.kernels.integer_vif.integer_vif_stats, adm_stats of ops.kernels.adm and ops.adm, "
        "ops.kernels.integer_adm.integer_adm_stats, and motion_stats and integer_blur of ops.kernels.motion "
        f"and ops.vmaf_motion (bare or through functools.partial), not {fn!r}: the port has no SPMD "
        "partitioner to split any function's columns, so width sharding is written into those entries' "
        "kernels (an owned-column window and a halo cut at upload); every other function has no strip loop "
        "of its own: the functions under those entries (VIF's scale wrappers vif_scale0 and vif_tail, "
        "whose windows a caller would chain by hand, plain building blocks such as block_sums or "
        "integer_vif_scale_planes), PSNR and the plain conversions"
    )
