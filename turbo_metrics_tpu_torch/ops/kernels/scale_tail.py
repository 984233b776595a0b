"""Kernel 2: the SSIMULACRA2 pyramid levels from a linear-RGB level plane.

``fused_pyramid_tail`` launches the CUDA kernels of csrc/ssimulacra2_scale.cu
(``tm_rgb_to_xyb`` + ``tm_level_sums`` per level, each level's 2x2 mean
feeding the next) on a CUDA tensor, and runs its plain twin
``fused_pyramid_tail_ref`` on a CPU tensor.  It replaces the JAX package's
``fused_pyramid_tail_pallas`` (turbo_metrics_tpu/ops/pallas/scale_tail.py:243),
which runs levels 1-5 after scale 0; here the level count is an argument, so
the same kernel also scores a whole pyramid from linear RGB.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import (
    check_level,
    check_level_consts,
    fused_scale_rgb_ref,
    launch_level,
    next_window,
    s2_level_scratch,
    window,
)


def _check_level(p12: torch.Tensor, num_levels: int) -> None:
    check_level(p12)
    if not 1 <= num_levels <= 6:
        raise ValueError(f"num_levels must be in [1, 6], got {num_levels}")


def fused_pyramid_tail_ref(p12, num_levels, taps, opsin, *, columns=None):
    """Plain twin of ``fused_pyramid_tail`` (same arguments and result)."""
    out = []
    win = None if columns is None else window(columns, p12.shape[-1])
    for li in range(num_levels):
        sums, p12 = fused_scale_rgb_ref(p12, taps, opsin, emit_ds=li + 1 < num_levels, columns=win)
        out.append(sums)
        win = None if win is None else next_window(*win)
    return torch.stack(out, dim=1)


def fused_pyramid_tail(
    p12: torch.Tensor, num_levels: int, taps: torch.Tensor, opsin: torch.Tensor, *,
    columns=None,
) -> torch.Tensor:
    """Sums of ``num_levels`` pyramid levels, the first being ``p12``.

    ``p12``: (2, B, 3, h, w) f32 linear RGB (reference, distorted), e.g. the
    level 1 that ``fused_scale0_yuv`` emits.  Each further level is the
    edge-replicated 2x2 mean of the one before.  Returns (B, num_levels, 3,
    6) f32 sums in ``norms_from_sums`` order, over the owned columns
    ``columns`` of the first level and their ``next_window`` on each next
    one.
    """
    _check_level(p12, num_levels)
    check_level_consts(taps, opsin, p12.device)
    clo, chi = window(columns, p12.shape[-1])
    if p12.device.type == "cpu":
        return fused_pyramid_tail_ref(p12, num_levels, taps, opsin, columns=columns)
    if p12.device.type != "cuda":
        raise ValueError(f"fused_pyramid_tail runs on cuda or cpu, not {p12.device}")
    lib = LIBRARY.get()
    _, bsz, _, h, w = p12.shape
    dev = p12.device
    scratch = s2_level_scratch(bsz, h, w, dev)  # the first level is the largest
    sums = torch.empty((bsz, num_levels, 3, 6), dtype=torch.float32, device=dev)
    cur = p12
    for li in range(num_levels):
        nxt = None
        if li + 1 < num_levels:
            nxt = torch.empty(
                (2, bsz, 3, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=dev
            )
        launch_level(
            lib, dev, taps, scratch, sums[:, li], num_levels * 18, nxt, bsz, h, w, clo, chi, "tm_rgb_to_xyb",
            (cur.data_ptr(), bsz, h, w, opsin.data_ptr()),
        )
        if nxt is not None:
            cur, h, w = nxt, (h + 1) // 2, (w + 1) // 2
            clo, chi = next_window(clo, chi)
    fused_pyramid_tail.launches += 1
    return sums


fused_pyramid_tail.launches = 0
