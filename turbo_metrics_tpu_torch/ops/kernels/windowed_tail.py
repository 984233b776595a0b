"""Kernel #12: the MS-SSIM levels after level 0.

``msssim_tail`` launches csrc/windowed.cu's ``tm_ssim_level`` once per level
on a CUDA tensor (each level's truncating 2x2 mean feeding the next, no
quantization) and runs its plain twin ``msssim_tail_ref`` on a CPU tensor.
It replaces the JAX package's ``msssim_tail_pallas``
(turbo_metrics_tpu/ops/pallas/windowed_tail.py:376), which runs levels 1-4
from the level 1 that the level-0 kernel emitted; here the level count is an
argument (the clamped count of ``quality._clamp_levels`` minus one).
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import quality
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY
from turbo_metrics_tpu_torch.ops.kernels.windowed import (
    WINDOW,
    check_ssim_level,
    launch_level,
    level_scratch,
    ssim_sums_ref,
)


def _check(q12, num_levels, window):
    check_ssim_level(q12, window)
    h, w = q12.shape[-2], q12.shape[-1]
    if num_levels < 1 or min(h, w) >> (num_levels - 1) < WINDOW:
        raise ValueError(f"{num_levels} levels from {h}x{w} leave a level under {WINDOW}x{WINDOW}")


def msssim_tail_ref(q12, num_levels, window, *, c1=quality.C1, c2=quality.C2):
    """Plain twin of ``msssim_tail`` (same arguments and result)."""
    out = []
    for li in range(num_levels):
        sums, nxt = ssim_sums_ref(q12, window, emit_ds=li + 1 < num_levels, c1=c1, c2=c2)
        out.append(sums)
        q12 = nxt
    return torch.stack(out, dim=1)


def msssim_tail(
    q12: torch.Tensor,
    num_levels: int,
    window: torch.Tensor,
    *,
    c1: float = quality.C1,
    c2: float = quality.C2,
) -> torch.Tensor:
    """Per-channel (sum(luminance*cs), sum(cs)) of ``num_levels`` MS-SSIM
    levels, the first being ``q12``.

    ``q12``: contiguous (2, B, 3, h, w) f32 code values (e.g. the level 1
    that ``ssim_sums`` emits); each further level is the truncating 2x2 mean
    of the one before.  Returns (B, num_levels, 3, 2) f32.
    """
    _check(q12, num_levels, window)
    if q12.device.type == "cpu":
        return msssim_tail_ref(q12, num_levels, window, c1=c1, c2=c2)
    if q12.device.type != "cuda":
        raise ValueError(f"msssim_tail runs on cuda or cpu, not {q12.device}")
    lib = LIBRARY.get()
    _, bsz, _, h, w = q12.shape
    dev = q12.device
    scratch = level_scratch(lib, bsz, h, w, dev)  # the first level is the largest
    sums = torch.empty((bsz, num_levels, 3, 2), dtype=torch.float32, device=dev)
    cur = q12
    for li in range(num_levels):
        nxt = None
        if li + 1 < num_levels:
            nxt = torch.empty((2, bsz, 3, h // 2, w // 2), dtype=torch.float32, device=dev)
        launch_level(lib, cur, window, False, c1, c2, sums[:, li], num_levels * 6, nxt, scratch)
        if nxt is not None:
            cur, h, w = nxt, h // 2, w // 2
    msssim_tail.launches += 1
    return sums


msssim_tail.launches = 0
