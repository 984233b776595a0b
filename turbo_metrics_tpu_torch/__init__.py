"""turbo-metrics in PyTorch + hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``turbo_metrics_tpu`` (which stays the
reference), slice by slice; see ROADMAP.md.  It imports ``torch`` and numpy,
never ``jax`` or ``turbo_metrics_tpu``.  Ported so far: SSIMULACRA2 on YUV
4:2:0 input through ``TurboMetrics`` and the CLI
(``python -m turbo_metrics_tpu_torch.cli``).
"""

__version__ = "0.1.0"
