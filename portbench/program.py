"""The program under test: the port's engine, fed from the ring.

``ResidentEngine`` is ``turbo_metrics_tpu_torch.engine.TurboMetrics`` with
one method replaced, ``_planes``: where the engine stacks a batch's decoded
host frames and uploads them, it hands over the ring block's planes, which
are already on the device.  Everything else of a batch is the engine's own:
``compute_frames``, the batch step (``_step``: conversion, the metric
families' launches, the stream state), the host scoring (``_scores``) and
the carry of XPSNR's and motion's state.  A change to the engine reaches
the cells as it is.

The harness hands ``compute_frames`` stand-ins for decoded frames
(``ResidentFrame``): each carries the pixel format that the engine's
conversion spec is made from, and names its input and its block of the
ring.  ``_step`` and ``_scores`` run inside the harness's spans
(``pb.launch``; ``pb.wait``, a device synchronisation that the scoring's
first readback would make anyway; ``pb.score``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    ColourPrimaries,
    MatrixCoefficients,
    TransferCharacteristic,
    matrix_name,
    transfer_name,
)
from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics

METRICS = ("psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf")


def engine_metrics(config: dict) -> Metrics:
    """The engine's metric selection of a configuration (its ``metrics``)."""
    unknown = set(config["metrics"]) - set(METRICS)
    if unknown:
        raise ValueError(f"configuration {config['name']!r}: unknown metrics {sorted(unknown)}")
    return Metrics(**{name: True for name in config["metrics"]})


def _member(enum_cls, name: str, namer, slot: str):
    """The member of ``enum_cls`` that the engine names ``name``."""
    base = ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.BT709)
    for member in enum_cls:
        try:
            if namer(dataclasses.replace(base, **{slot: member})) == name:
                return member
        except NotImplementedError:
            continue
    raise ValueError(f"no {enum_cls.__name__} that the engine names {name!r}")


def colour(fmt: dict) -> tuple[ColorCharacteristics, str]:
    """The (characteristics, range) pair that ``compute_frames`` takes for
    one input of a workload."""
    if fmt["kind"] == "rgb":
        return ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709,
                                    TransferCharacteristic.SRGB), "full"
    mc = _member(MatrixCoefficients, fmt["matrix"], matrix_name, "mc")
    tc = _member(TransferCharacteristic, fmt["transfer"], transfer_name, "tc")
    return ColorCharacteristics(ColourPrimaries.BT709, mc, tc), fmt["range"]


@dataclasses.dataclass(frozen=True)
class ResidentFrame:
    """A decoded frame that is already on the device, in block ``block``
    of the ring's ``side`` ("ref" or "dis"), with the fields of the
    engine's ``RawFrame`` that its conversion spec reads."""

    side: str
    block: int
    kind: str
    depth: int
    chroma: int


def _frames(side: str, fmt: dict, blocks: int, batch: int) -> list[list[ResidentFrame]]:
    kind, chroma = ("rgb", 444) if fmt["kind"] == "rgb" else ("yuv420", fmt["chroma"])
    return [[ResidentFrame(side, k, kind, fmt["depth"], chroma) for _ in range(batch)] for k in range(blocks)]


class ResidentEngine(TurboMetrics):
    """The engine with the ring's resident planes in place of its upload."""

    def __init__(self, config: dict, width: int, height: int, *, batch: int | None, device):
        super().__init__(width, height, engine_metrics(config), batch=batch, device=device)
        self.spans = lambda name: contextlib.nullcontext()
        self.ring = None

    def attach(self, ring, workload: dict) -> None:
        """Feed the engine from ``ring``, whose inputs ``workload`` names."""
        if ring.batch != self.batch:
            raise ValueError(f"the ring's batch {ring.batch} is not the engine's {self.batch}")
        self.ring = ring
        self.cc_ref, self.cc_dis = colour(workload["ref"]), colour(workload["dis"])
        self.frames_ref = _frames("ref", workload["ref"], ring.blocks, ring.batch)
        self.frames_dis = _frames("dis", workload["dis"], ring.blocks, ring.batch)

    def run_block(self, k: int):
        """Block ``k`` of the ring through ``compute_frames``: its frames'
        ``FrameScores``."""
        return self.compute_frames(self.frames_ref[k], self.cc_ref, self.frames_dis[k], self.cc_dis)

    def _planes(self, dev: torch.device, *inputs) -> tuple[torch.Tensor, ...]:
        """The engine's planes of one input's frames, or of two inputs'
        stacked on a leading axis of 2, taken from the ring: the same
        layouts as the upload's."""
        block = inputs[0][0].block
        sides = ("ref", "dis") if len(inputs) == 2 else (inputs[0][0].side,)
        if any(frames is not getattr(self, f"frames_{side}")[block] for frames, side in zip(inputs, sides)):
            raise ValueError("the engine asked for frames that are not one whole block of the ring")
        planes = self.ring.batch_planes(block)
        key = "pair" if len(inputs) == 2 else sides[0]
        if key not in planes:
            raise ValueError(f"the engine asks for {key!r} planes; the ring holds {sorted(planes)}")
        return planes[key]

    def _step(self, *args, **kwargs):
        with self.spans("pb.launch"):
            return super()._step(*args, **kwargs)

    def _scores(self, *args, **kwargs):
        with self.spans("pb.wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self.spans("pb.score"):
            return super()._scores(*args, **kwargs)
