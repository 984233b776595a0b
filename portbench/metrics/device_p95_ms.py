"""device_p95_ms: the 95th percentile over the traced batches of the time in
which the device ran the batch's operations."""

import numpy as np


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return float(np.percentile(np.array(run.trace.batch_device_s()) * 1e3, 95))
