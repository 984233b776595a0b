"""launch_ms: mean host time per batch of the engine's step, from its
first call to its last launch returning (the ``pb.launch`` span), over the
untraced window (host clock)."""

import numpy as np


def read(run):
    spans = run.spans_s.get("pb.launch")
    return float(np.mean(spans) * 1e3) if spans else None
