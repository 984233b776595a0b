"""wait_ms: host ms a batch that the engine's loop waited for the frame
prefetcher's next batch (its span ``tm.prefetch.wait``,
parallel/streaming.FramePrefetcher), over the untraced window of a
host-fed cell's ``--trace 1`` run; None where the engine's spans were not
recorded."""

from portbench.metrics.stack_ms import engine_span_ms


def read(run):
    return engine_span_ms(run, "tm.prefetch.wait")
