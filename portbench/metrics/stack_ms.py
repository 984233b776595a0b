"""stack_ms: host ms a batch in the engine's ``np.stack`` of a batch's
decoded frames (its span ``tm.planes.stack``, engine._planes), over the
untraced window of a host-fed cell's ``--trace 1`` run; None where the
engine's spans were not recorded."""

def engine_span_ms(run, span: str):
    """Host ms a batch (``tm.batch``) in the engine's span ``span``, or
    None without its records."""
    if run.records is None or span not in run.records.spans:
        return None
    return 1e3 * run.records.spans[span].total_s / run.records.per("tm.batch")


def read(run):
    return engine_span_ms(run, "tm.planes.stack")
