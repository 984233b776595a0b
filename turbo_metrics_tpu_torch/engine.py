"""The pipeline engine: batches frame pairs and scores them on one device.

Counterpart of the JAX package's ``TurboMetrics`` (itself modelled on
turbo-metrics/src/lib.rs:188-434) for SSIMULACRA2, PSNR, SSIM and MS-SSIM on
YUV 4:2:0 input.  The host stacks each batch of decoded planes and uploads
them; the device runs one of two routes (the JAX engine's ``_get_step``):
  * SSIMULACRA2 alone, both inputs of one conversion spec: scale 0 straight
    from YUV (models/ssimulacra2.ssimulacra2_subscores_from_yuv);
  * otherwise, the multi-metric route: one conversion
    (ops/kernels/convert.py) fills a (2, B, 3, h, w) linear-RGB pair buffer,
    one launch for a shared spec or one per image when the specs differ, and
    every requested family reads it (ops/quality.quality_from_rgb,
    models/ssimulacra2.ssimulacra2_subscores_from_rgb).
Only per-frame values and the (B, 3, S, 2, 3) sub-scores come back; the
108-weight score runs on the host in f64.  XPSNR and VMAF are not ported yet
and raise.
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
from turbo_metrics_tpu_torch.ops.kernels.convert import yuv420_to_linear_rgb_pair
from turbo_metrics_tpu_torch.ops.quality import Quality
from turbo_metrics_tpu_torch.utils.stats import Stats


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to turbo_metrics_tpu_torch yet (ROADMAP.md {item}); "
        "use turbo_metrics_tpu for it"
    )


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


class TurboMetrics:
    """Per-resolution metric engine on an explicit ``device`` ('cuda' or
    'cpu'; 'cuda' raises when CUDA is absent — never a silent fallback)."""

    def __init__(
        self,
        width: int,
        height: int,
        metrics: Metrics,
        *,
        batch: int | None = None,
        device="cuda",
    ):
        if not metrics.any():
            raise ValueError("at least one metric must be selected")
        others = [n for n in ("xpsnr", "vmaf") if getattr(metrics, n)]
        if others:
            raise not_ported(f"metric(s) {', '.join(others)}", "Queue 1 items 6-8")
        if (metrics.ssim or metrics.msssim) and min(width, height) < 11:
            raise ValueError("SSIM and MS-SSIM need frames of at least 11x11")
        self.width = int(width)
        self.height = int(height)
        self.metrics = metrics
        self.device = resolve_device(device)
        self.model = (
            Ssimulacra2(self.width, self.height, device=self.device) if metrics.ssimulacra2 else None
        )
        self.quality = (
            Quality(device=self.device) if metrics.psnr or metrics.ssim or metrics.msssim else None
        )
        self.batch = batch if batch is not None else default_batch(width, height, metrics)

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
        n = len(ref_frames)
        # Pad a partial batch to the full batch by repeating its last frame,
        # so every step sees one shape; padded scores are dropped below.
        if n < self.batch:
            pad = self.batch - n
            ref_frames = ref_frames + [ref_frames[-1]] * pad
            dis_frames = dis_frames + [dis_frames[-1]] * pad
        spec = ConvertSpec.for_frame(ref_frames[0], *cc_ref)
        spec_dis = ConvertSpec.for_frame(dis_frames[0], *cc_dis)
        if any(s.kind != "yuv420" or s.chroma != 420 for s in (spec, spec_dis)):
            raise not_ported(
                f"input format {spec.kind}/{spec.chroma} -> {spec_dis.kind}/{spec_dis.chroma}",
                "Queue 1 item 4",
            )
        m = self.metrics
        scores = [FrameScores() for _ in range(n)]
        if self.quality is None and spec_dis == spec:
            # SSIMULACRA2 alone: scale 0 conversion-fused, no RGB pair buffer.
            sub = self.model.subscores_from_yuv(
                *self._planes(ref_frames, dis_frames),
                depth=spec.depth,
                matrix=spec.matrix,
                transfer=spec.transfer,
                full_range=spec.full_range,
            )
            s2 = self.model.score(sub)
            for i in range(n):
                scores[i].ssimulacra2 = float(s2[i])
            return scores
        p12 = self._linear_rgb_pair(ref_frames, spec, dis_frames, spec_dis)
        if self.quality is not None:
            out = self.quality.from_rgb(p12, psnr=m.psnr, ssim=m.ssim, msssim=m.msssim)
            for name, vals in out.items():
                vals = vals.cpu().numpy().astype(np.float64)
                for i in range(n):
                    setattr(scores[i], name, float(vals[i]))
        if self.model is not None:
            s2 = self.model.score(self.model.subscores_from_rgb(p12))
            for i in range(n):
                scores[i].ssimulacra2 = float(s2[i])
        return scores

    def _planes(self, *inputs: list[RawFrame]) -> tuple[torch.Tensor, torch.Tensor]:
        """Luma and chroma of one input's frames on the device, (B, h, w) and
        (B, ch, cw, 2), or of two inputs' stacked, (2, B, ...)."""
        y = np.stack([np.stack([f.y for f in frames]) for frames in inputs])
        uv = np.stack([np.stack([f.uv for f in frames]) for frames in inputs])
        if len(inputs) == 1:
            y, uv = y[0], uv[0]
        return torch.from_numpy(y).to(self.device), torch.from_numpy(uv).to(self.device)

    def _linear_rgb_pair(
        self, ref_frames: list[RawFrame], spec_ref: ConvertSpec,
        dis_frames: list[RawFrame], spec_dis: ConvertSpec,
    ) -> torch.Tensor:
        """The (2, B, 3, h, w) linear-RGB pair buffer of a batch: one
        conversion launch for a shared spec, one per image into its slot
        when the specs differ (engine.py:600-629 of the JAX package)."""

        def kw(spec):
            kr_kb = self.model.kr_kb[spec.matrix] if self.model is not None else None
            return dict(depth=spec.depth, matrix=spec.matrix, transfer=spec.transfer,
                        full_range=spec.full_range, kr_kb=kr_kb)

        if spec_ref == spec_dis:
            return yuv420_to_linear_rgb_pair(*self._planes(ref_frames, dis_frames), **kw(spec_ref))
        p12 = torch.empty(
            (2, len(ref_frames), 3, self.height, self.width), dtype=torch.float32, device=self.device
        )
        for slot, (frames, spec) in enumerate(((ref_frames, spec_ref), (dis_frames, spec_dis))):
            yuv420_to_linear_rgb_pair(*self._planes(frames), p12, slot, **kw(spec))
        return p12

    def compute_one(
        self,
        ref_frame: RawFrame,
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frame: RawFrame,
        cc_dis: tuple[ColorCharacteristics, str],
    ) -> FrameScores:
        """Single frame-pair API (turbo-metrics/src/lib.rs:268-360)."""
        return self.compute_frames([ref_frame], cc_ref, [dis_frame], cc_dis)[0]

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

        def consume(batch_ref: list[RawFrame], batch_dis: list[RawFrame]):
            nonlocal compute_count
            for s in self.compute_frames(batch_ref, cc_ref, batch_dis, cc_dis):
                for name, lst in acc.items():
                    v = getattr(s, name)
                    if lst is not None and v is not None:
                        lst.append(v)
                if on_frame is not None:
                    on_frame(s)
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

        return MetricsResults(
            frame_count=compute_count,
            resolution_changed=res_change,
            **{name: _aggregate(acc[name]) for name in METRIC_NAMES},
        )


def default_batch(width: int, height: int, metrics: Optional[Metrics] = None) -> int:
    """Frame pairs per device step: 8 at 1080p, provisional.

    Device bytes per pixel pair.  SSIMULACRA2 alone: about 80 (XYB 24, four
    row-blurred planes 48, level 1 6, planes 3); 8 pairs at 1080p are ~1.3
    GB.  The multi-metric route: the linear-RGB pair buffer 24 and the
    planes 3 (6 at 16 bits), plus SSIMULACRA2 78 (XYB, row planes, level 1),
    the SSIM family 54 (four row-correlated planes, the emitted level) and
    PSNR 48 (quantized pair and its difference); all four at 1080p are
    ~0.43 GB per pair.  No batch ladder has been measured on the H100 yet,
    so the cap is a guess to revisit (the JAX package's TPU ladders do not
    transfer).
    """
    m = metrics or Metrics(ssimulacra2=True)
    if not (m.psnr or m.ssim or m.msssim):
        per_px = 80
    else:
        per_px = 30 + 78 * m.ssimulacra2 + 54 * (m.ssim or m.msssim) + 48 * m.psnr
    per_pair = per_px * width * height
    budget = 4 << 30
    return int(np.clip(budget // max(per_pair, 1), 1, 8))
