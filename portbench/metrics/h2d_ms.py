"""h2d_ms: host ms a batch in the engine's upload of a batch's stacked
planes from pageable host memory to the card (its span
``tm.planes.upload``, ``.to(dev)`` in engine._planes), over the untraced
window of a host-fed cell's ``--trace 1`` run; None where the engine's
spans were not recorded."""

from portbench.metrics.stack_ms import engine_span_ms


def read(run):
    return engine_span_ms(run, "tm.planes.upload")
