"""Measurement tools of the port (``python -m turbo_metrics_tpu_torch.tools.<name>``)."""
