"""roofline_pct: the least time of the window's metric work (roofline.py,
from the metrics' definitions at the cell's shapes) over the device time of
the batches' kernels, memsets and copies in the trace, in percent."""


def read(run):
    if run.trace is None:
        return None
    device_s = sum(run.trace.batch_device_s())
    if device_s <= 0:
        return None
    return 100.0 * len(run.trace.spans["pb.batch"]) * run.work.least_seconds() / device_s
