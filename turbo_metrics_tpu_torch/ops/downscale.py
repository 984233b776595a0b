"""2x2 mean downscale with edge-clamped borders (SSIMULACRA2 pyramid step).

Matches the canonical downscale (reference: ssimulacra2-cuda/examples/cpu.rs:545-579):
output dims are ceil(in/2); when a 2x2 window reads past the right/bottom
edge the last row/column is replicated; the four samples are summed in f32
then scaled by 1/4.
"""

from __future__ import annotations

import torch


def downscale_by_2(x: torch.Tensor) -> torch.Tensor:
    """Downscale the last two axes by 2 (ceil), edge-replicated."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if w % 2:
        x = torch.cat([x, x[..., :, -1:]], dim=-1)
    s = ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2]) + x[..., 1::2, 1::2]
    return s * 0.25


def scale_dims(h: int, w: int, num_scales: int = 6) -> list[tuple[int, int]]:
    """Pyramid dims actually computed, mirroring the reference loop guard
    (examples/cpu.rs:358-366): the `< 8` check applies to the dims *before*
    the scale's downscale, so a scale may be computed at dims below 8 (e.g.
    96x128 yields 5 scales, the last at 6x8)."""
    dims: list[tuple[int, int]] = []
    for s in range(num_scales):
        if h < 8 or w < 8:
            break
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        dims.append((h, w))
    return dims
