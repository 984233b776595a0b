"""CLI stdout formats: default / JSON / JSON-lines / CSV.

Contract parity with the reference CLI (turbo-metrics-cli/src/output.rs:6-143):
  * default — human-readable aggregate stats only;
  * json — one pretty object with per-frame scores and stats;
  * json-lines — one JSON object per frame, then one stats object;
  * csv — header plus one row per frame.
"""

from __future__ import annotations

import json
from enum import Enum
from typing import Optional

from turbo_metrics_tpu_torch.engine import (
    FrameScores,
    Metrics,
    MetricsResults,
    metric_enabled,
)

METRIC_ORDER = (
    "psnr", "ssim", "msssim", "ssimulacra2", "xpsnr",
    "vmaf", "vmaf_motion", "vmaf_vif",
    "vmaf_vif_scale0", "vmaf_vif_scale1", "vmaf_vif_scale2", "vmaf_vif_scale3",
    "vmaf_adm",
    "vmaf_adm_scale0", "vmaf_adm_scale1", "vmaf_adm_scale2", "vmaf_adm_scale3",
)


class Output(Enum):
    DEFAULT = "default"
    JSON = "json"
    JSON_LINES = "json-lines"
    CSV = "csv"

    def prepare(self, metrics: Metrics) -> None:
        if self is Output.CSV:
            cols = [m for m in METRIC_ORDER if metric_enabled(metrics, m)]
            print(",".join(cols))

    def output_single_score(self, scores: FrameScores) -> None:
        if self is Output.JSON_LINES:
            print(json.dumps(scores.to_dict()))
        elif self is Output.CSV:
            vals = [
                _fmt(getattr(scores, m))
                for m in METRIC_ORDER
                if getattr(scores, m) is not None
            ]
            print(",".join(vals))

    def output_results(self, results: MetricsResults) -> None:
        if self is Output.DEFAULT:
            for m in METRIC_ORDER:
                agg = getattr(results, m)
                if agg is not None:
                    print(f"{m.upper()}: {json.dumps(agg.stats.to_dict(), indent=2)}")
        elif self is Output.JSON:
            obj: dict = {"frame_count": results.frame_count}
            for m in METRIC_ORDER:
                agg = getattr(results, m)
                if agg is not None:
                    obj[m] = {"scores": agg.scores, "stats": agg.stats.to_dict()}
            print(json.dumps(obj, indent=2))
        elif self is Output.JSON_LINES:
            obj = {"frame_count": results.frame_count}
            for m in METRIC_ORDER:
                agg = getattr(results, m)
                if agg is not None:
                    obj[m] = agg.stats.to_dict()
            print(json.dumps(obj))
        elif self is Output.CSV:
            cols = [m for m in METRIC_ORDER if getattr(results, m) is not None]
            print(",".join(cols))
            for i in range(results.frame_count):
                print(
                    ",".join(
                        _fmt(getattr(results, m).scores[i]) for m in cols
                    )
                )

    @property
    def streams_frames(self) -> bool:
        """Whether per-frame output happens during the run."""
        return self in (Output.JSON_LINES, Output.CSV)


def _fmt(x: Optional[float]) -> str:
    return "" if x is None else repr(float(x))
