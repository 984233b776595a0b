"""Kernel #4: every remaining small SSIMULACRA2 level in one launch.

``fused_tail`` launches the persistent cooperative kernel of
csrc/ssimulacra2_tail.cu (``tm_fused_tail``: per level a quad pass and the
fused tile pass of kernel 2's levels, levels + 1 grid syncs) on a CUDA
tensor, and runs its plain twin ``fused_tail_ref`` on a CPU tensor.  It
replaces the JAX package's ``fused_tail_pallas``
(turbo_metrics_tpu/ops/pallas/scale_stats.py:2494), which the level chain (models/ssimulacra2.level_sums_chain) runs once the
level plane is small (``tail_plane_bytes`` within ``TAIL_MAX_BYTES``): at
3840x2160 on levels 3-5.  Its sums equal kernel 2's on the same plane (the
same per-pixel code and reduction trees).
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import (
    check_level,
    check_level_consts,
    level_blocks,
    window,
)
from turbo_metrics_tpu_torch.ops.kernels.scale_tail import fused_pyramid_tail_ref

# The twin: a loop of fused_scale_rgb_ref over the levels, each level's 2x2
# mean feeding the next (the same arithmetic as kernel 2's twin).
fused_tail_ref = fused_pyramid_tail_ref


def scratch_floats(bsz: int, h: int, w: int, num_levels: int) -> dict:
    """The f32 scratch of one launch from an h x w first level, by part, in
    the order of one allocation: the XYB pair of the even levels (the first
    is the largest) and of the odd ones, two planes for the next levels'
    linear RGB in turn, and the 32x8 partials of every level, each rounded
    up to whole 16-byte chunks so that the next starts aligned for the
    kernel's 16-byte loads.  The tile pass keeps its row-blurred planes in
    shared memory: they take no device memory."""
    n = 2 * bsz * 3 * h * w
    n_next = 2 * bsz * 3 * ((h + 1) // 2) * ((w + 1) // 2) if num_levels > 1 else 0
    parts = 0
    for _ in range(num_levels):
        parts += bsz * 3 * level_blocks(h, w) * 6
        h, w = (h + 1) // 2, (w + 1) // 2
    sizes = {"xyb_even": n, "xyb_odd": n_next, "lvl_a": n_next, "lvl_b": n_next, "parts": parts}
    return {k: -(-v // 4) * 4 for k, v in sizes.items()}


def fused_tail(
    p12: torch.Tensor, num_levels: int, taps: torch.Tensor, opsin: torch.Tensor, *,
    columns=None,
) -> torch.Tensor:
    """Sums of ``num_levels`` pyramid levels, the first being ``p12``, in one
    launch.

    ``p12``: contiguous (2, B, 3, h, w) f32 linear RGB (reference,
    distorted).  Each further level is the edge-replicated 2x2 mean of the one
    before.  Returns (B, num_levels, 3, 6) f32 sums in ``norms_from_sums``
    order, over the owned columns ``columns`` of the first level and their
    ``next_window`` on each next one (scale_stats module docstring).  A
    launch that the card refuses raises; nothing falls back.
    """
    check_level(p12)
    if not 1 <= num_levels <= 6:
        raise ValueError(f"num_levels must be in [1, 6], got {num_levels}")
    check_level_consts(taps, opsin, p12.device)
    clo, chi = window(columns, p12.shape[-1])
    if p12.device.type == "cpu":
        return fused_tail_ref(p12, num_levels, taps, opsin, columns=columns)
    if p12.device.type != "cuda":
        raise ValueError(f"fused_tail runs on cuda or cpu, not {p12.device}")
    lib = LIBRARY.get()
    _, bsz, _, h, w = p12.shape
    sizes = scratch_floats(bsz, h, w, num_levels)
    scratch = torch.empty(sum(sizes.values()), dtype=torch.float32, device=p12.device)
    at, ptr = scratch.data_ptr(), {}
    for name, n in sizes.items():
        ptr[name] = at
        at += n * scratch.element_size()
    sums = torch.empty((bsz, num_levels, 3, 6), dtype=torch.float32, device=p12.device)
    with launch_stream(p12.device) as stream:
        check(
            lib.tm_fused_tail(
                p12.data_ptr(), bsz, h, w, clo, chi, num_levels, taps.data_ptr(), opsin.data_ptr(),
                ptr["xyb_even"], ptr["xyb_odd"], ptr["lvl_a"], ptr["lvl_b"], ptr["parts"],
                sums.data_ptr(), stream,
            ),
            "tm_fused_tail",
        )
    fused_tail.launches += 1
    return sums


fused_tail.launches = 0
