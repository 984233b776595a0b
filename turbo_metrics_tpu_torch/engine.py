"""The pipeline engine: batches frame pairs and scores them on one device,
or on the shards of a mesh (``TurboMetrics(mesh=...)``, parallel/mesh.py).

Counterpart of the JAX package's ``TurboMetrics`` (itself modelled on
turbo-metrics/src/lib.rs:188-434) for SSIMULACRA2, PSNR, SSIM, MS-SSIM,
XPSNR and VMAF's float features on planar YUV (4:2:0, 4:2:2, 4:4:4) and
packed RGB input.  The host
stacks each batch of decoded frames and uploads them; the device runs (the
JAX engine's ``_get_step``):
  * for the RGB families, one of three routes.  SSIMULACRA2 as the only
    one, both inputs of one 4:2:0 conversion spec: scale 0 straight from YUV
    (models/ssimulacra2.ssimulacra2_subscores_from_yuv).  SSIMULACRA2 as the
    only one, both inputs packed integer sRGB (uint8 or uint16) of one spec:
    scale 0 straight from the codes through a code table
    (models/ssimulacra2.ssimulacra2_subscores_from_srgb).  Otherwise the
    multi-metric route: a (2, B, 3, h, w) linear-RGB pair buffer, filled by
    one conversion launch for a shared YUV spec or one per image when the
    specs differ (ops/kernels/convert.py: #6 for 4:2:0, #5 for 4:2:2 and
    4:4:4; the plain sRGB conversion for RGB sources), which every requested
    family reads (ops/quality.quality_from_rgb,
    models/ssimulacra2.ssimulacra2_subscores_from_rgb);
  * for XPSNR, the block statistics of the luma code values
    (ops/kernels/xpsnr.py), the distorted luma aligned to the reference's
    depth, with the previous reference frame carried from batch to batch;
  * for VMAF (the JAX engine's ``_luma_metric_outs``), on the same luma
    codes: the motion blur and row SADs (ops/kernels/motion.py), with the
    previous blurred frame carried from batch to batch, and VIF and ADM
    (ops/kernels/vif.py, ops/kernels/adm.py) on the pair in 8-bit units, or
    with ``vmaf_integer`` their fixed-point conventions on the luma codes
    themselves (ops/kernels/integer_vif.py, ops/kernels/integer_adm.py).
Only per-frame values, the (B, 3, S, 2, 3) sub-scores, the XPSNR block
grids and VMAF's sums come back, read once every launch of the batch is
queued; the SSIMULACRA2 score, the XPSNR weighting, VMAF's feature scores
and its fusion model run on the host in f64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    matrix_name,
    transfer_name,
)
from turbo_metrics_tpu_torch.io.frame_source import FrameSource, RawFrame
from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, resolve_device
from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.kernels.convert import (
    yuv420_to_linear_rgb_pair,
    yuv_to_linear_rgb,
)
from turbo_metrics_tpu_torch.ops.adm import adm_score
from turbo_metrics_tpu_torch.ops.kernels.adm import adm_stats
from turbo_metrics_tpu_torch.ops.kernels.integer_adm import integer_adm_stats
from turbo_metrics_tpu_torch.ops.kernels.integer_vif import integer_vif_stats
from turbo_metrics_tpu_torch.ops.kernels.motion import integer_blur, motion_stats
from turbo_metrics_tpu_torch.ops.kernels.vif import vif_scale_stats
from turbo_metrics_tpu_torch.ops.kernels.xpsnr import xpsnr_block_stats
from turbo_metrics_tpu_torch.ops.quality import Quality
from turbo_metrics_tpu_torch.ops.vif import vif_scores
from turbo_metrics_tpu_torch.ops.vmaf_motion import motion_score
from turbo_metrics_tpu_torch.ops.xpsnr_ops import align_luma_depth, frames_db
from turbo_metrics_tpu_torch.parallel.mesh import frames_per_shard, gather_frames, launch_shards
from turbo_metrics_tpu_torch.utils import profiling
from turbo_metrics_tpu_torch.utils.profiling import span, to_host
from turbo_metrics_tpu_torch.utils.stats import Stats


@dataclass
class Metrics:
    """Metric selection (turbo-metrics/src/lib.rs:27-37, extended with XPSNR)."""

    psnr: bool = False
    ssim: bool = False
    msssim: bool = False
    ssimulacra2: bool = False
    xpsnr: bool = False
    vmaf: bool = False
    vmaf_fused: bool = False

    def any(self) -> bool:
        return (
            self.psnr
            or self.ssim
            or self.msssim
            or self.ssimulacra2
            or self.xpsnr
            or self.vmaf
        )


@dataclass
class Options:
    """Frame-subsetting options (turbo-metrics/src/lib.rs:39-54)."""

    every: int = 0
    skip: int = 0
    skip_ref: int = 0
    skip_dis: int = 0
    frames: int = 0


@dataclass
class FrameScores:
    psnr: Optional[float] = None
    ssim: Optional[float] = None
    msssim: Optional[float] = None
    ssimulacra2: Optional[float] = None
    xpsnr: Optional[float] = None
    vmaf: Optional[float] = None
    vmaf_motion: Optional[float] = None
    vmaf_vif: Optional[float] = None
    vmaf_vif_scale0: Optional[float] = None
    vmaf_vif_scale1: Optional[float] = None
    vmaf_vif_scale2: Optional[float] = None
    vmaf_vif_scale3: Optional[float] = None
    vmaf_adm: Optional[float] = None
    vmaf_adm_scale0: Optional[float] = None
    vmaf_adm_scale1: Optional[float] = None
    vmaf_adm_scale2: Optional[float] = None
    vmaf_adm_scale3: Optional[float] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class MetricAggregate:
    scores: list[float]
    stats: Stats


@dataclass
class MetricsResults:
    frame_count: int
    # Set when the run stopped because a source reconfigured mid-stream; the
    # CLI rebuilds the engine and continues, merging segment results.
    resolution_changed: Optional[tuple[int, int]] = None
    psnr: Optional[MetricAggregate] = None
    ssim: Optional[MetricAggregate] = None
    msssim: Optional[MetricAggregate] = None
    ssimulacra2: Optional[MetricAggregate] = None
    xpsnr: Optional[MetricAggregate] = None
    vmaf: Optional[MetricAggregate] = None
    vmaf_motion: Optional[MetricAggregate] = None
    vmaf_vif: Optional[MetricAggregate] = None
    vmaf_vif_scale0: Optional[MetricAggregate] = None
    vmaf_vif_scale1: Optional[MetricAggregate] = None
    vmaf_vif_scale2: Optional[MetricAggregate] = None
    vmaf_vif_scale3: Optional[MetricAggregate] = None
    vmaf_adm: Optional[MetricAggregate] = None
    vmaf_adm_scale0: Optional[MetricAggregate] = None
    vmaf_adm_scale1: Optional[MetricAggregate] = None
    vmaf_adm_scale2: Optional[MetricAggregate] = None
    vmaf_adm_scale3: Optional[MetricAggregate] = None


METRIC_NAMES = (
    "psnr", "ssim", "msssim", "ssimulacra2", "xpsnr",
    "vmaf", "vmaf_motion", "vmaf_vif",
    "vmaf_vif_scale0", "vmaf_vif_scale1", "vmaf_vif_scale2", "vmaf_vif_scale3",
    "vmaf_adm",
    "vmaf_adm_scale0", "vmaf_adm_scale1", "vmaf_adm_scale2", "vmaf_adm_scale3",
)


def metric_enabled(metrics: Metrics, name: str) -> bool:
    """Whether an output column/field is active for this metric selection."""
    if name == "vmaf":
        return metrics.vmaf and metrics.vmaf_fused
    if name.startswith("vmaf_"):
        return metrics.vmaf
    return getattr(metrics, name)


def _aggregate(scores: Optional[list[float]]) -> Optional[MetricAggregate]:
    if scores is None:
        return None
    return MetricAggregate(scores=scores, stats=Stats.compute(scores))


def merge_results(parts: list[MetricsResults]) -> MetricsResults:
    """Concatenate per-segment results (mid-stream reconfiguration) into one
    MetricsResults with stats recomputed over the full stream."""
    if len(parts) == 1:
        return parts[0]
    merged = MetricsResults(frame_count=sum(p.frame_count for p in parts))
    merged.resolution_changed = parts[-1].resolution_changed
    for name in METRIC_NAMES:
        scores: list[float] = []
        any_set = False
        for p in parts:
            agg = getattr(p, name)
            if agg is not None:
                any_set = True
                scores.extend(agg.scores)
        if any_set:
            setattr(merged, name, _aggregate(scores))
    return merged


@dataclass(frozen=True)
class ConvertSpec:
    """Static description of an input frame format -> linear RGB conversion."""

    kind: str  # 'yuv420' (any planar YUV; see chroma) | 'rgb'
    depth: int
    matrix: str
    transfer: str
    full_range: bool
    chroma: int = 420  # 420 | 422 | 444 subsampling of the uv plane

    @classmethod
    def for_frame(
        cls, frame: RawFrame, cc: ColorCharacteristics, crange: str
    ) -> "ConvertSpec":
        if frame.kind == "rgb":
            # Packed RGB sources are gamma sRGB (turbo-metrics/src/color.rs:112-114).
            return cls("rgb", frame.depth, "identity", "srgb", True)
        return cls(
            "yuv420",
            frame.depth,
            matrix_name(cc),
            transfer_name(cc),
            crange == "full",
            frame.chroma,
        )


def _luma_code(spec: ConvertSpec, arrays: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Integer luma code values (B, H, W) for XPSNR and VMAF.

    YUV sources use the decoded Y plane directly (as the reference does);
    RGB sources derive gamma-domain luma with BT.709 weights, in f32, rounded
    half to even (the JAX engine's ``_luma_code``).
    """
    if spec.kind == "yuv420":
        return arrays[0]
    rgb = arrays[0].to(torch.float32)
    kr, kb = colorspace.MATRIX_KR_KB["bt709"]
    kg = 1.0 - kr - kb
    f32 = colorspace._f32
    y = f32(kr) * rgb[..., 0] + f32(kg) * rgb[..., 1] + f32(kb) * rgb[..., 2]
    return torch.round(y).to(torch.int32).contiguous()


def vmaf_pair(y_ref: torch.Tensor, y_dis: torch.Tensor, depth_ref: int, depth_dis: int) -> torch.Tensor:
    """VIF's and ADM's input: the (2, B, H, W) f32 luma pair in 8-bit units,
    the distorted luma aligned to the reference's depth first."""
    y_dis = align_luma_depth(y_dis, depth_dis, depth_ref)
    scale8 = torch.tensor(np.float32(255.0 / ((1 << depth_ref) - 1)), device=y_ref.device)
    return torch.stack([y_ref.to(torch.float32), y_dis.to(torch.float32)]) * scale8


def vmaf_code_pair(y_ref: torch.Tensor, y_dis: torch.Tensor, depth_ref: int, depth_dis: int) -> torch.Tensor:
    """The fixed-point VIF's and ADM's input: the (2, B, H, W) pair of luma
    codes in the reference's type (uint8, uint16 or int32), the distorted
    luma aligned to the reference's depth first (where its codes then fit)."""
    y_dis = align_luma_depth(y_dis, depth_dis, depth_ref)
    return torch.stack([y_ref, y_dis.to(y_ref.dtype)])


class _VmafFuser:
    """Streams FrameScores through the fusion model with one frame of
    holdback: libvmaf's 'motion2' feature for frame i is
    min(motion[i], motion[i+1]), so a frame's fused score is only final once
    the next frame's motion is known (the last frame keeps its own motion,
    matching libvmaf's end-of-stream behaviour)."""

    def __init__(self, model):
        self.model = model
        self.pending: Optional[FrameScores] = None

    def push(self, s: FrameScores) -> Optional[FrameScores]:
        ready = None
        if self.pending is not None:
            self._fuse(self.pending, next_motion=s.vmaf_motion)
            ready = self.pending
        self.pending = s
        return ready

    def flush(self) -> Optional[FrameScores]:
        if self.pending is not None:
            self._fuse(self.pending, next_motion=None)
        ready, self.pending = self.pending, None
        return ready

    def _fuse(self, s: FrameScores, next_motion: Optional[float]) -> None:
        m = s.vmaf_motion
        m2 = m if next_motion is None else min(m, next_motion)
        feats = {
            "adm2": s.vmaf_adm,
            "motion": m,
            "motion2": m2,
            "vif": s.vmaf_vif,
            **{f"vif_scale{k}": getattr(s, f"vmaf_vif_scale{k}") for k in range(4)},
            **{f"adm_scale{k}": getattr(s, f"vmaf_adm_scale{k}") for k in range(4)},
        }
        s.vmaf = self.model.predict_one(feats)


class TurboMetrics:
    """Per-resolution metric engine on an explicit ``device`` ('cuda' or
    'cpu'; 'cuda' raises when CUDA is absent — never a silent fallback).

    ``vmaf_model`` (models.vmaf_model.VmafModel): the fusion model of the
    ``vmaf`` score; without one, ``Metrics(vmaf=True)`` gives the elementary
    features only.  ``vmaf_integer``: VIF and ADM under libvmaf-style
    fixed-point conventions (the repository's own 32-bit schedule, not
    claimed bit-identical to libvmaf) instead of the float pipeline.

    ``mesh`` (parallel.mesh.Mesh): shard each batch's frames over the mesh's
    devices, which then replace ``device`` (the JAX engine's ``mesh=``,
    engine.py:495-556 of the JAX package).  The batch rounds up to a
    multiple of the mesh's size; each shard's frames are uploaded straight
    to its device and run there under its own stream, every shard launched
    before any result is read, and the host scores the gathered results in
    frame order.  Shard k > 0 also receives the previous shard's last
    reference frame, uploaded once more: XPSNR's previous frame and, blurred
    on its own device (#17), VMAF motion's previous blurred plane, so
    shards never wait on each other (the JAX engine exchanges that plane
    with a ppermute; the blur is exact, so the integers are the same).
    Shard 0 takes the stream state, and the last shard's state carries to
    the next batch."""

    def __init__(
        self,
        width: int,
        height: int,
        metrics: Metrics,
        *,
        batch: int | None = None,
        device="cuda",
        vmaf_model=None,
        vmaf_integer: bool = False,
        mesh=None,
    ):
        if not metrics.any():
            raise ValueError("at least one metric must be selected")
        if (metrics.ssim or metrics.msssim) and min(width, height) < 11:
            raise ValueError("SSIM and MS-SSIM need frames of at least 11x11")
        self.width = int(width)
        self.height = int(height)
        self.metrics = metrics
        self.mesh = mesh
        devices = [resolve_device(d) for d in ((device,) if mesh is None else mesh.distinct_devices())]
        # One SSIMULACRA2 model and one Quality per device.
        self._models = {
            dev: (
                Ssimulacra2(self.width, self.height, device=dev) if metrics.ssimulacra2 else None,
                Quality(device=dev) if metrics.psnr or metrics.ssim or metrics.msssim else None,
            )
            for dev in devices
        }
        self.device = devices[0]
        self.model, self.quality = self._models[self.device]
        self.batch = batch if batch is not None else default_batch(width, height, metrics)
        if mesh is not None and self.batch % mesh.size:
            # Round the batch up so that every shard gets equal frames.
            self.batch = -(-self.batch // mesh.size) * mesh.size
        # XPSNR temporal state: the last reference luma of the previous batch.
        self._prev_ref: Optional[torch.Tensor] = None
        # VMAF motion state: the previous batch's last blurred reference luma.
        self._vmaf_prev_blur: Optional[torch.Tensor] = None
        # XPSNR's block grids on the host, reused from batch to batch (_host_grids).
        self._grids_host: Optional[torch.Tensor] = None
        self.vmaf_model = vmaf_model
        self.vmaf_integer = vmaf_integer
        if vmaf_model is not None:
            metrics.vmaf_fused = True

    def reset_stream_state(self) -> None:
        """Clear temporal state before scoring a new clip with this engine."""
        self._prev_ref = None
        self._vmaf_prev_blur = None

    # -- host batching -----------------------------------------------------

    def compute_frames(
        self,
        ref_frames: list[RawFrame],
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frames: list[RawFrame],
        cc_dis: tuple[ColorCharacteristics, str],
    ) -> list[FrameScores]:
        """Compute all selected metrics for a batch of frame pairs."""
        if len(ref_frames) != len(dis_frames) or not ref_frames:
            raise ValueError("need equal, non-zero numbers of ref and dis frames")
        with span("tm.batch"):
            n = len(ref_frames)
            # Pad a partial batch to the full batch by repeating its last frame,
            # so every step sees one shape; padded scores are dropped below.  The
            # XPSNR state stays right because the padding is the last real frame.
            # Over a mesh, a longer call pads to a multiple of the mesh's size.
            size = 1 if self.mesh is None else self.mesh.size
            target = -(-max(n, self.batch) // size) * size
            if n < target:
                pad = target - n
                ref_frames = ref_frames + [ref_frames[-1]] * pad
                dis_frames = dis_frames + [dis_frames[-1]] * pad
            spec = ConvertSpec.for_frame(ref_frames[0], *cc_ref)
            spec_dis = ConvertSpec.for_frame(dis_frames[0], *cc_dis)
            first = self.metrics.vmaf and self._vmaf_prev_blur is None
            if self.mesh is None:
                out, state = self._step(
                    self.device, spec, ref_frames, spec_dis, dis_frames, self._prev_ref, self._vmaf_prev_blur
                )
            else:
                out, state = self._mesh_step(spec, ref_frames, spec_dis, dis_frames)
            scores = self._scores(out, n, spec, first)
            # Replaced once the scores are read: the shards may read the old
            # state until then.
            if self.metrics.xpsnr:
                self._prev_ref = state[0]
            if self.metrics.vmaf:
                self._vmaf_prev_blur = state[1]
            return scores

    def _mesh_step(self, spec: ConvertSpec, ref_frames: list, spec_dis: ConvertSpec, dis_frames: list):
        """``_step`` on every shard of the mesh; returns the gathered
        results and the last shard's state."""
        mesh = self.mesh
        per = frames_per_shard(len(ref_frames), mesh)
        m = self.metrics

        def shard(k: int, dev: torch.device):
            a = k * per
            prev_ref = prev_blur = None
            if k == 0:
                # The stream state, from the previous batch's last shard.
                if self._prev_ref is not None:
                    prev_ref = self._prev_ref.to(dev)
                if self._vmaf_prev_blur is not None:
                    prev_blur = self._vmaf_prev_blur.to(dev)
            elif m.xpsnr or m.vmaf:
                # The previous shard's last reference frame, uploaded again.
                prev = _luma_code(spec, self._planes(dev, ref_frames[a - 1:a]))
                prev_ref = prev[0]
                if m.vmaf:
                    prev_blur = integer_blur(prev, depth=spec.depth)[0]
            return self._step(
                dev, spec, ref_frames[a:a + per], spec_dis, dis_frames[a:a + per], prev_ref, prev_blur
            )

        results = launch_shards(shard, mesh)
        return gather_frames([out for out, _ in results], mesh, per), results[-1][1]

    def _step(
        self, dev: torch.device, spec: ConvertSpec, ref_frames: list, spec_dis: ConvertSpec,
        dis_frames: list, prev_ref: Optional[torch.Tensor], prev_blur: Optional[torch.Tensor],
    ) -> tuple[dict, tuple]:
        """Upload the frames to ``dev`` and launch every selected metric's
        kernels there.  ``prev_ref``: the reference luma before the first
        frame (None: the stream's first frame, its own); ``prev_blur``: its
        blurred plane (None: the stream's first frame).  Returns the
        per-frame results as device tensors (nothing is read back) and the
        state after the last frame, (last reference luma, its blurred
        plane)."""
        with span("tm.step"):
            m = self.metrics
            model, quality = self._models[dev]
            out: dict = {}
            last_ref = last_blur = None
            # Planar YUV of one spec for both inputs is uploaded as one (2, B, ...)
            # stack, so that one conversion launch covers the pair.
            pair = None
            with span("tm.planes"):
                if spec == spec_dis and spec.kind == "yuv420":
                    pair = self._planes(dev, ref_frames, dis_frames)
                    arr_ref, arr_dis = tuple(a[0] for a in pair), tuple(a[1] for a in pair)
                else:
                    arr_ref, arr_dis = self._planes(dev, ref_frames), self._planes(dev, dis_frames)
            s2_alone = model is not None and quality is None
            s2_from_yuv = s2_alone and pair is not None and spec.chroma == 420
            s2_from_rgb = (
                s2_alone and spec.kind == "rgb" and spec.transfer == "srgb" and spec == spec_dis
                and arr_ref[0].dtype == arr_dis[0].dtype and model.takes_codes(arr_ref[0].dtype)
            )
            if s2_from_yuv:
                # SSIMULACRA2 the only RGB family: scale 0 conversion-fused, no
                # RGB pair buffer.
                with span("tm.step.ssimulacra2"):
                    out["ssimulacra2"] = model.subscores_from_yuv(
                        *pair,
                        depth=spec.depth,
                        matrix=spec.matrix,
                        transfer=spec.transfer,
                        full_range=spec.full_range,
                    )
            elif s2_from_rgb:
                # The same for packed integer RGB: scale 0 straight from the
                # codes, no RGB pair buffer.
                with span("tm.step.ssimulacra2"):
                    out["ssimulacra2"] = model.subscores_from_srgb(arr_ref[0], arr_dis[0], depth=spec.depth)
            elif model is not None or quality is not None:
                with span("tm.step.convert"):
                    p12 = self._linear_rgb_pair(dev, spec, arr_ref, spec_dis, arr_dis, pair)
                if quality is not None:
                    with span("tm.step.quality"):
                        out.update(quality.from_rgb(p12, psnr=m.psnr, ssim=m.ssim, msssim=m.msssim))
                if model is not None:
                    with span("tm.step.ssimulacra2"):
                        out["ssimulacra2"] = model.subscores_from_rgb(p12)
            if m.xpsnr:
                with span("tm.step.xpsnr"):
                    out["xpsnr"], last_ref = self._xpsnr(spec, arr_ref, spec_dis, arr_dis, prev_ref)
            if m.vmaf:
                with span("tm.step.vmaf"):
                    vmaf, last_blur = self._vmaf(spec, arr_ref, spec_dis, arr_dis, prev_blur)
                out.update(vmaf)
            return out, (last_ref, last_blur)

    def _scores(self, out: dict, n: int, spec_ref: ConvertSpec, first: bool) -> list[FrameScores]:
        """The host's part: the first ``n`` frames' scores from a step's
        device results (the SSIMULACRA2 score, the XPSNR weighting and
        VMAF's feature scores in f64).  While the recording is on, the wait
        for the batch's device work, which the first readback makes anyway,
        is a span of its own (``tm.wait``)."""
        with span("tm.score"):
            if profiling.recording():
                with span("tm.wait"):
                    profiling.synchronize(out)
            scores = [FrameScores() for _ in range(n)]
            if self.quality is not None:
                with span("tm.score.quality"):
                    for name in ("psnr", "ssim", "msssim"):
                        if name in out:
                            vals = to_host(out[name]).astype(np.float64)
                            for i in range(n):
                                setattr(scores[i], name, float(vals[i]))
            if "ssimulacra2" in out:
                with span("tm.score.ssimulacra2"):
                    s2 = self.model.score(out["ssimulacra2"])
                    for i in range(n):
                        scores[i].ssimulacra2 = float(s2[i])
            if "xpsnr" in out:
                with span("tm.score.xpsnr"):
                    # As in the JAX engine: an RGB reference is weighted at 8
                    # bits, whatever its depth.
                    depth = spec_ref.depth if spec_ref.kind == "yuv420" else 8
                    db = frames_db(self._host_grids(out["xpsnr"]), width=self.width, height=self.height, depth=depth)
                    for s, v in zip(scores, db):
                        s.xpsnr = v
            if "vif" in out:
                with span("tm.score.vmaf"):
                    vs = vif_scores(to_host(out["vif"]))
                    adm = adm_score(to_host(out["adm"]), self.height, self.width)
                    sads = to_host(out["sad"])
                    for i, s in enumerate(scores):
                        s.vmaf_vif = float(vs["vif"][i])
                        s.vmaf_adm = float(adm["adm2"][i])
                        for k in range(4):
                            setattr(s, f"vmaf_vif_scale{k}", float(vs[f"vif_scale{k}"][i]))
                            setattr(s, f"vmaf_adm_scale{k}", float(adm[f"adm_scale{k}"][i]))
                        s.vmaf_motion = motion_score(int(sads[i]), self.width, self.height, depth=spec_ref.depth)
                    if first:
                        scores[0].vmaf_motion = 0.0
            return scores

    def _host_grids(self, stats: dict) -> dict:
        """XPSNR's block grids read back into one host buffer that the engine
        keeps (pinned where the grids come from a card) and reuses in every
        batch: NumPy views, valid until the next batch's readback.  Each
        grid of a 4K batch of 4 is ~1 MB; filling fresh host memory with
        them took 6-10 ms a batch in some processes on the H100's host,
        against ~0.4 ms into a reused buffer (PERF.md section 5)."""
        first = next(iter(stats.values()))
        shape = (len(stats), *first.shape)
        buf = self._grids_host
        if buf is None or buf.shape != shape or buf.dtype != first.dtype:
            buf = self._grids_host = torch.empty(shape, dtype=first.dtype, pin_memory=first.is_cuda)
        return {k: to_host(v, out=buf[i]) for i, (k, v) in enumerate(stats.items())}

    def _planes(self, dev: torch.device, *inputs: list[RawFrame]) -> tuple[torch.Tensor, ...]:
        """One input's frames on ``dev``, or two inputs' stacked on a
        leading axis of 2: (luma (B, h, w), chroma (B, ch, cw, 2)) for planar
        YUV, (rgb (B, h, w, 3),) for packed RGB."""
        fields = ("rgb",) if inputs[0][0].kind == "rgb" else ("y", "uv")
        out = []
        for field in fields:
            with span("tm.planes.stack"):
                a = np.stack([np.stack([getattr(f, field) for f in frames]) for frames in inputs])
            with span("tm.planes.upload"):
                out.append(torch.from_numpy(a[0] if len(inputs) == 1 else a).to(dev))
            profiling.count("upload_bytes", a.nbytes)
        return tuple(out)

    def _linear_rgb_pair(
        self, dev: torch.device, spec_ref: ConvertSpec, arr_ref: tuple, spec_dis: ConvertSpec,
        arr_dis: tuple, pair: Optional[tuple] = None,
    ) -> torch.Tensor:
        """The (2, B, 3, h, w) linear-RGB pair buffer of a batch: one
        conversion launch for the stacked ``pair`` planes of a shared YUV
        spec, else one conversion per image into its slot (engine.py:600-629
        and :214-252 of the JAX package)."""
        if pair is not None:
            return self._convert(spec_ref, pair)
        p12 = torch.empty(
            (2, arr_ref[0].shape[0], 3, self.height, self.width),
            dtype=torch.float32, device=dev,
        )
        for slot, (spec, arrays) in enumerate(((spec_ref, arr_ref), (spec_dis, arr_dis))):
            self._convert(spec, arrays, p12, slot)
        return p12

    def _convert(self, spec: ConvertSpec, arrays: tuple, p12=None, slot=None) -> torch.Tensor:
        """Linear RGB of one input's ``arrays`` into ``p12[slot]`` (then
        ``p12`` is returned), or of a stacked pair into a new buffer."""
        if spec.kind == "rgb":
            # Plain torch, left only to RGB beside PSNR, SSIM or MS-SSIM and
            # to float RGB: SSIMULACRA2 alone on integer sRGB codes converts
            # inside its first level pass (``_step``).
            colorspace.packed_rgb_to_linear(arrays[0], p12[slot], depth=spec.depth, transfer=spec.transfer)
            return p12
        kw = dict(
            depth=spec.depth, matrix=spec.matrix, transfer=spec.transfer,
            full_range=spec.full_range,
            kr_kb=self.model.kr_kb[spec.matrix] if self.model is not None else None,
        )
        if spec.chroma == 420:
            return yuv420_to_linear_rgb_pair(*arrays, p12, slot, **kw)
        if p12 is None:
            return yuv_to_linear_rgb(*arrays, chroma=spec.chroma, **kw)
        yuv_to_linear_rgb(*arrays, p12[slot], chroma=spec.chroma, **kw)
        return p12

    def _xpsnr(
        self, spec_ref: ConvertSpec, arr_ref: tuple, spec_dis: ConvertSpec, arr_dis: tuple,
        prev_ref: Optional[torch.Tensor],
    ) -> tuple[dict, torch.Tensor]:
        """XPSNR's block grids of the batch's frames (engine.py:302-314,
        :913-919 and :980-992 of the JAX package) and the last reference
        luma."""
        y_ref = _luma_code(spec_ref, arr_ref)
        y_dis = _luma_code(spec_dis, arr_dis)
        # The stream's first frame is its own previous frame (tact 0).
        prev0 = y_ref[0] if prev_ref is None else prev_ref.to(y_ref.dtype)
        # The JAX engine's _align_luma_depth, as a shift the kernel applies
        # while it reads: XPSNR compares raw code values, so a pair whose
        # inputs differ in depth is compared at the reference's depth.
        stats = xpsnr_block_stats(y_ref, y_dis, prev0, dis_shift=spec_ref.depth - spec_dis.depth)
        return stats, y_ref[-1].clone()

    def _vmaf(
        self, spec_ref: ConvertSpec, arr_ref: tuple, spec_dis: ConvertSpec, arr_dis: tuple,
        prev_blur: Optional[torch.Tensor],
    ) -> tuple[dict, torch.Tensor]:
        """VMAF's elementary sums of the batch's frames (engine.py:315-374
        and :920-979 of the JAX package): {'vif', 'adm', 'sad'}, and the
        last blurred reference luma."""
        depth = spec_ref.depth
        y_ref = _luma_code(spec_ref, arr_ref)
        if prev_blur is None:
            # The stream's first frame is its own previous frame (motion 0).
            prev_blur = integer_blur(y_ref[:1], depth=depth)[0]
        mot = motion_stats(y_ref, prev_blur, depth=depth)
        if self.vmaf_integer:
            # The fixed-point path takes the integer codes themselves, at the
            # reference's depth (engine.py:326-334 of the JAX package).
            pair = vmaf_code_pair(y_ref, _luma_code(spec_dis, arr_dis), depth, spec_dis.depth)
            vif_sums = integer_vif_stats(pair, depth=depth)
            adm_sums = integer_adm_stats(pair, depth=depth)
        else:
            pair = vmaf_pair(y_ref, _luma_code(spec_dis, arr_dis), depth, spec_dis.depth)
            vif_sums = vif_scale_stats(pair)
            adm_sums = adm_stats(pair)
        # The padding repeats the last real frame, so the last plane is its.
        out = {"vif": vif_sums, "adm": adm_sums, "sad": mot["sad_rows"].sum(dim=-1)}
        return out, mot["blurred"][-1].clone()

    def compute_one(
        self,
        ref_frame: RawFrame,
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frame: RawFrame,
        cc_dis: tuple[ColorCharacteristics, str],
    ) -> FrameScores:
        """Single frame-pair API (turbo-metrics/src/lib.rs:268-360).

        With a fusion model loaded the score uses motion2 == motion (no
        lookahead exists for a single pair)."""
        s = self.compute_frames([ref_frame], cc_ref, [dis_frame], cc_dis)[0]
        if self.vmaf_model is not None and s.vmaf_motion is not None:
            _VmafFuser(self.vmaf_model)._fuse(s, next_motion=None)
        return s

    # -- full drive loop ----------------------------------------------------

    def compute_all(
        self,
        frames_ref: FrameSource,
        frames_dis: FrameSource,
        opts: Options = Options(),
        on_frame: Optional[Callable[[FrameScores], None]] = None,
        *,
        prefetch: bool = True,
    ) -> MetricsResults:
        """Drive both sources to exhaustion (turbo-metrics/src/lib.rs:362-433).

        Frame subsetting (every/skip/frames) matches the reference's loop
        semantics.  Pairs are accumulated into batches of ``self.batch``;
        ``on_frame`` is called per frame pair in order.  With ``prefetch`` a
        background thread decodes the next batch while the device computes.
        """
        if (frames_ref.width, frames_ref.height) != (frames_dis.width, frames_dis.height):
            raise ValueError("Reference and distorted are not the same size")

        cc_ref = frames_ref.color_characteristics()
        cc_dis = frames_dis.color_characteristics()

        m = self.metrics
        acc: dict[str, Optional[list[float]]] = {
            name: ([] if metric_enabled(m, name) else None) for name in METRIC_NAMES
        }

        frames_ref.skip_frames(opts.skip_ref + opts.skip)
        frames_dis.skip_frames(opts.skip_dis + opts.skip)

        compute_count = 0
        fuser = _VmafFuser(self.vmaf_model) if m.vmaf and self.vmaf_model is not None else None

        def emit(s: FrameScores) -> None:
            for name, lst in acc.items():
                v = getattr(s, name)
                if lst is not None and v is not None:
                    lst.append(v)
            if on_frame is not None:
                on_frame(s)

        def consume(batch_ref: list[RawFrame], batch_dis: list[RawFrame]):
            nonlocal compute_count
            for s in self.compute_frames(batch_ref, cc_ref, batch_dis, cc_dis):
                ready = fuser.push(s) if fuser is not None else s
                if ready is not None:
                    emit(ready)
                compute_count += 1

        from turbo_metrics_tpu_torch.io.frame_source import ResolutionChanged

        res_change: Optional[tuple[int, int]] = None
        if prefetch:
            from turbo_metrics_tpu_torch.parallel.streaming import FramePrefetcher

            batches = FramePrefetcher(
                frames_ref,
                frames_dis,
                batch=self.batch,
                every=opts.every,
                frames=opts.frames,
            )
            try:
                for batch_ref, batch_dis in batches:
                    consume(batch_ref, batch_dis)
            except ResolutionChanged as e:
                res_change = (e.width, e.height)
        else:
            pend_ref: list[RawFrame] = []
            pend_dis: list[RawFrame] = []
            decode_count = 0
            while True:
                fref = fdis = None
                try:
                    fref = frames_ref.get_frame()
                    fdis = frames_dis.get_frame()
                except ResolutionChanged as e:
                    # Keep the pair lockstep: return an already-fetched mate
                    # so the new segment starts with matched frames.
                    if fref is not None:
                        frames_ref.push_back(fref)
                    res_change = (e.width, e.height)
                    break
                if fref is None or fdis is None:
                    break
                if opts.every > 1 and decode_count != 0 and decode_count % opts.every != 0:
                    decode_count += 1
                    continue
                if opts.frames > 0 and decode_count >= opts.frames:
                    break
                decode_count += 1
                pend_ref.append(fref)
                pend_dis.append(fdis)
                if len(pend_ref) >= self.batch:
                    consume(pend_ref, pend_dis)
                    pend_ref, pend_dis = [], []
            if pend_ref:
                consume(pend_ref, pend_dis)

        if fuser is not None:
            ready = fuser.flush()
            if ready is not None:
                emit(ready)

        return MetricsResults(
            frame_count=compute_count,
            resolution_changed=res_change,
            **{name: _aggregate(acc[name]) for name in METRIC_NAMES},
        )


def default_batch(width: int, height: int, metrics: Optional[Metrics] = None) -> int:
    """Frame pairs per device step: 8 at 1080p, provisional.

    Device bytes per pixel pair, at most (the formats are not known yet):
    the uploaded planes 12 (16-bit 4:4:4 or 16-bit RGB; 3 at 8-bit 4:2:0);
    XPSNR 8 (int32 luma codes of RGB sources; its grids are 3/32); the
    linear-RGB pair buffer 24 with any RGB family, plus SSIMULACRA2 78 (XYB
    24, level 1 6, and 48 for four row-blurred planes), the SSIM family 54
    (four row-correlated planes 48, the emitted level) and PSNR 48
    (quantized pair and its difference); VMAF 62 (the aligned distorted luma
    8, the f32 pair 8, VIF's five row-blurred planes and emission 24 and
    level 1 2, ADM's row-filtered planes 8, band planes 9 and approximation
    2, the blurred luma 2).  All six at 1080p are ~0.6 GB per pair.  The
    fused tile kernels keep SSIMULACRA2's and the SSIM family's four
    row-filtered planes, VIF's row-blurred planes and emission rows, and
    ADM's row-filtered and band planes in shared memory: none of those
    planes exists in device memory any more, so these terms overstate by
    48 + 48 + 24 + 8 + 9 bytes per pixel pair.  The
    numbers stay until a batch ladder measured on the H100 replaces them
    (the JAX package's TPU ladders do not transfer), since they set the
    batch of every route.
    """
    m = metrics or Metrics(ssimulacra2=True)
    per_px = 12 + 8 * m.xpsnr + 62 * m.vmaf
    if m.ssimulacra2 or m.psnr or m.ssim or m.msssim:
        per_px += 24 + 78 * m.ssimulacra2 + 54 * (m.ssim or m.msssim) + 48 * m.psnr
    per_pair = per_px * width * height
    budget = 4 << 30
    return int(np.clip(budget // max(per_pair, 1), 1, 8))
