"""Device ops: plain torch versions and the CUDA kernels (ops/kernels)."""
