"""The benchmark of turbo_metrics_tpu_torch on NVIDIA GPUs (README.md)."""
