"""batch_p95_ms: the 95th percentile over every batch of the window of the
time from handing its planes to the program to holding all its per-frame
scores on the host (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(np.array(run.latencies_s) * 1e3, 95)) if run.latencies_s else None
