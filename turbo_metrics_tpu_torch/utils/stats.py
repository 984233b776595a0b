"""Score aggregation statistics (parity with the reference's quick-stats).

Mirrors quick_stats::full::Stats (quick-stats/src/lib.rs:4-97): min/max/mean,
population and sample variance/stddev, and linearly-interpolated percentiles
p1/p5/p50/p95/p99.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np


@dataclass
class Stats:
    min: float
    max: float
    mean: float
    var: float
    sample_var: float
    stddev: float
    sample_stddev: float
    p1: float
    p5: float
    p50: float
    p95: float
    p99: float

    @classmethod
    def compute(cls, values: Sequence[float]) -> "Stats":
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            raise ValueError("Stats.compute requires at least one value")
        s = np.sort(v)
        mean = float(s.sum() / v.size)
        # inf scores (e.g. PSNR of identical frames) make variance NaN; that
        # is faithful to the math and mirrors the reference's f64 pipeline.
        with np.errstate(invalid="ignore"):
            if v.size < 2:
                var = sample_var = 0.0
            else:
                sq = float(((v - mean) ** 2).sum())
                var = sq / v.size
                sample_var = sq / (v.size - 1)
        return cls(
            min=float(s[0]),
            max=float(s[-1]),
            mean=mean,
            var=var,
            sample_var=sample_var,
            stddev=float(np.sqrt(var)),
            sample_stddev=float(np.sqrt(sample_var)),
            p1=_percentile_of_sorted(s, 1.0),
            p5=_percentile_of_sorted(s, 5.0),
            p50=_percentile_of_sorted(s, 50.0),
            p95=_percentile_of_sorted(s, 95.0),
            p99=_percentile_of_sorted(s, 99.0),
        )

    def to_dict(self) -> dict:
        return asdict(self)


def _percentile_of_sorted(sorted_samples: np.ndarray, pct: float) -> float:
    """Linear-interpolated percentile (quick-stats/src/lib.rs:56-76)."""
    assert sorted_samples.size > 0 and 0.0 <= pct <= 100.0
    if sorted_samples.size == 1:
        return float(sorted_samples[0])
    if pct == 100.0:
        return float(sorted_samples[-1])
    rank = (pct / 100.0) * (sorted_samples.size - 1)
    lrank = np.floor(rank)
    d = rank - lrank
    n = int(lrank)
    lo = sorted_samples[n]
    hi = sorted_samples[n + 1]
    if lo == hi:  # also avoids inf - inf
        return float(lo)
    return float(lo + (hi - lo) * d)
