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

Width sharding (the JAX package's ``spatial_sharding`` and
``shard_over_width``, which split one frame's columns over the devices) is
not here yet.  Those rely on XLA's SPMD partitioner to insert the halo
exchanges the separable blurs need into any function; PyTorch has no such
partitioner, so the port's counterpart has to be written into the kernels:
column strips that start on even columns, a halo of 5 columns per level
copied between devices, and a window of owned columns in the level kernels'
sums (csrc/ssimulacra2_level.cuh).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

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


def _upload(chunk, dev: torch.device) -> torch.Tensor:
    if isinstance(chunk, np.ndarray):
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
    return chunk.to(dev)


def split_frames(t, mesh: Mesh) -> list:
    """Equal leading-dim chunks of ``t`` (a tensor or a numpy array), chunk
    k on ``mesh.devices[k]``: the counterpart of the JAX package's
    ``frame_sharding``.  The leading dim must split evenly."""
    per = frames_per_shard(t.shape[0], mesh)
    return [_upload(t[k * per:(k + 1) * per], d) for k, d in enumerate(mesh.devices)]


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
            lambda k, dev: fn(*(_upload(a[k * per:(k + 1) * per], dev) for a in args)), mesh
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
