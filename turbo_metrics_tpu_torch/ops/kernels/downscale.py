"""Kernel #7: the SSIMULACRA2 pyramid step, the 2x2 mean of an image.

``downscale_by_2`` launches ``tm_downscale2`` (csrc/downscale.cu) on a CUDA
tensor and runs its plain twin ``ops.downscale.downscale_by_2`` on a CPU
tensor; the two agree bit for bit (the kernel sums in the twin's order).  It
replaces the JAX package's ``downscale_by_2_pallas``
(turbo_metrics_tpu/ops/pallas/convert.py:500), the level step of the
``pallas2`` backend (models/ssimulacra2.ssimulacra2_subscores).
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import downscale as plain
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream

downscale_by_2_ref = plain.downscale_by_2


def downscale_by_2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) f32 -> (N, C, ceil(h/2), ceil(w/2)): the 2x2 mean, the
    last row/column replicated where h or w is odd."""
    if x.ndim != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, C, h, w) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, c, h, w = x.shape
    if x.device.type == "cpu":
        return downscale_by_2_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"downscale_by_2 runs on cuda or cpu, not {x.device}")
    if not 1 <= n * c <= 65535:
        raise ValueError(f"N*C must be in [1, 65535], got {n * c}")
    out = torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=x.device)
    with launch_stream(x.device) as stream:
        check(LIBRARY.get().tm_downscale2(x.data_ptr(), n * c, h, w, out.data_ptr(), stream),
              "tm_downscale2")
    downscale_by_2.launches += 1
    return out


downscale_by_2.launches = 0
