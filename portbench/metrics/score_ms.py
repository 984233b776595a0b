"""score_ms: mean host time per batch of the engine's scoring, once the
device is done: the readbacks and the float64 scores to Python floats (the
``pb.score`` span), over the untraced window (host clock)."""

import numpy as np


def read(run):
    spans = run.spans_s.get("pb.score")
    return float(np.mean(spans) * 1e3) if spans else None
