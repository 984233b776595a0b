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
    valid_window,
)


def _check(q12, num_levels, window, columns):
    check_ssim_level(q12, window, columns is not None)
    h, w = q12.shape[-2], q12.shape[-1]
    if num_levels < 1 or (h if columns is not None else min(h, w)) >> (num_levels - 1) < WINDOW:
        raise ValueError(f"{num_levels} levels from {h}x{w} leave a level under {WINDOW}x{WINDOW}")


def level_columns(columns, num_levels: int) -> list:
    """Each level's owned columns from the first level's ``columns`` = (lo,
    hi): level l's edges are the first's halved l times (exact where they
    sit on multiples of 2^(num_levels-1), or at the level's width, as a
    strip's do); None for every level where ``columns`` is None."""
    if columns is None:
        return [None] * num_levels
    lo, hi = (int(c) for c in columns)
    return [(lo >> li, hi >> li) for li in range(num_levels)]


def _levels_run(w: int, num_levels: int, columns) -> int:
    """How many levels from the first run: all of them, or with ``columns``
    those at least 11 columns wide (a strip's narrower levels own no valid
    output and add zeros)."""
    if columns is None:
        return num_levels
    return sum(1 for li in range(num_levels) if w >> li >= WINDOW)


def msssim_tail_ref(q12, num_levels, window, *, c1=quality.C1, c2=quality.C2, columns=None):
    """Plain twin of ``msssim_tail`` (same arguments and result)."""
    run = _levels_run(q12.shape[-1], num_levels, columns)
    zeros = torch.zeros((q12.shape[1], 3, 2), dtype=torch.float32, device=q12.device)
    out = []
    for li, cols in enumerate(level_columns(columns, num_levels)):
        if li >= run:
            out.append(zeros)
            continue
        sums, nxt = ssim_sums_ref(q12, window, emit_ds=li + 1 < run, c1=c1, c2=c2, columns=cols)
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
    columns=None,
) -> torch.Tensor:
    """Per-channel (sum(luminance*cs), sum(cs)) of ``num_levels`` MS-SSIM
    levels, the first being ``q12``.

    ``q12``: contiguous (2, B, 3, h, w) f32 code values (e.g. the level 1
    that ``ssim_sums`` emits); each further level is the truncating 2x2 mean
    of the one before.  ``columns``: the first level's owned columns (None:
    the whole width), each level's window ``level_columns`` of it, summed as
    ``ssim_sums`` sums a window; a strip's level narrower than the 11-wide
    window adds zeros without a launch.  Returns (B, num_levels, 3, 2) f32.
    """
    _check(q12, num_levels, window, columns)
    if q12.device.type == "cpu":
        return msssim_tail_ref(q12, num_levels, window, c1=c1, c2=c2, columns=columns)
    if q12.device.type != "cuda":
        raise ValueError(f"msssim_tail runs on cuda or cpu, not {q12.device}")
    _, bsz, _, h, w = q12.shape
    dev = q12.device
    run = _levels_run(w, num_levels, columns)
    alloc = torch.empty if run == num_levels else torch.zeros
    sums = alloc((bsz, num_levels, 3, 2), dtype=torch.float32, device=dev)
    if not run:
        return sums
    lib = LIBRARY.get()
    parts = level_scratch(bsz, h, w, dev)  # the first level is the largest
    cur = q12
    for li, cols in enumerate(level_columns(columns, run)):
        nxt = None
        if li + 1 < run:
            nxt = torch.empty((2, bsz, 3, h // 2, w // 2), dtype=torch.float32, device=dev)
        launch_level(lib, cur, window, False, c1, c2, sums[:, li], num_levels * 6, nxt,
                     valid_window(cols, w), parts)
        if nxt is not None:
            cur, h, w = nxt, h // 2, w // 2
    msssim_tail.launches += 1
    return sums


msssim_tail.launches = 0
