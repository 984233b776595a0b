from turbo_metrics_tpu_torch.cli import run

if __name__ == "__main__":
    import sys

    sys.exit(run())
