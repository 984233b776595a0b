"""tail_ms: device ms per traced batch of SSIMULACRA2's kernel #4,
``fused_tail_kernel`` (one cooperative launch over the pyramid's small
levels: 3-5 at 3840x2160), inside the traced window; None where it never
ran."""

TAIL_KERNEL = "fused_tail_kernel"


def tail_seconds(trace) -> float:
    """Seconds of device time of the tail kernel in the traced window."""
    return dict(trace.device_ops(top=None)).get(TAIL_KERNEL, 0.0)


def read(run):
    if run.trace is None:
        return None
    seconds = tail_seconds(run.trace)
    if seconds <= 0:
        return None
    return 1e3 * seconds / len(run.trace.spans["pb.batch"])
