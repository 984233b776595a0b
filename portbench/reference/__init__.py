"""The plain reference that decides a run's ``correct``.

Plain PyTorch, written from the metrics' published definitions; it imports
nothing of the program under test (``turbo_metrics_tpu_torch``) nor of the
JAX package, and takes no constant, table or plane that the program made.
Every function takes the raw planes that the benchmark generated and a
``dtype`` for its per-pixel arithmetic: float64 for the reference, bfloat16
for the control (the same code one precision step below the float32 that
the configurations state).  Sums are taken in float64 for the reference and
in float32 for the control.

``frame_scores`` (scores.py) turns a block of frame pairs into the
per-frame values that the harness compares with the program's.
"""
