"""idle_pct: the share of the traced window, from the first batch's start to
the last one's end, in which no operation ran on the device."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
