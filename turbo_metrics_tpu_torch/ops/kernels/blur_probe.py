"""Kernel #19: the blur-only timing probe of the kernel dissect tool.

``blur_only`` launches ``tm_blur_probe`` (csrc/blur_probe.cu) on a CUDA
tensor and runs its plain twin ``blur_only_ref`` on a CPU tensor.  It
replaces the probe of the JAX package's tools/kernel_dissect.py
(``blur_only``, pallas_call at l.106): ``passes`` repetitions of the
SSIMULACRA2 11-tap row blur then column blur of every plane, each summed over
the region the TPU probe's 128x512 tiles cover, rows [0, nth*128) x columns
[0, ntw*512) with nth = ceil(H/128) and ntw = ceil(W/512).  The image is
zero-extended, so the region counts the blur's spill past the bottom and
right edges and not past the top and left ones.  The sums are a by-product
of the timing, not a metric.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from turbo_metrics_tpu_torch.ops.gaussian import blur_2d, taps_f32
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream

# The TPU probe's output tile, whose whole tiles make the summed region.
TILE_H, TILE_W = 128, 512


def _planes(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) or (P, H, W) contiguous f32 -> (P, H, W)."""
    if img.ndim not in (3, 4) or (img.ndim == 4 and img.shape[1] != 3):
        raise ValueError(f"img must be (B, 3, H, W) or (P, H, W), got {tuple(img.shape)}")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"img must be contiguous float32, got {img.dtype}")
    return img.reshape(-1, img.shape[-2], img.shape[-1])


def region(h: int, w: int) -> tuple[int, int]:
    """The summed region of an h x w plane: whole tiles, (rows, columns)."""
    return -(-h // TILE_H) * TILE_H, -(-w // TILE_W) * TILE_W


def _taps(taps, device) -> torch.Tensor:
    """The (11,) f32 taps on ``device``: a tensor as given, or any sequence
    (``taps_f32()``) copied there."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.tensor(taps_f32(taps), dtype=torch.float32, device=device)
    if taps.shape != (11,) or taps.dtype != torch.float32 or taps.device != device:
        raise ValueError(f"taps must be an (11,) float32 tensor on {device}")
    return taps.contiguous()


def blur_only_ref(img, taps, *, passes=5):
    """Plain twin of ``blur_only`` (same arguments and result): the
    zero-extended blur of the plane padded at the bottom and right to the
    region, summed per plane in f64 and multiplied by ``passes``."""
    x = _planes(img)
    p, h, w = x.shape
    rh, rw = region(h, w)
    blurred = blur_2d(F.pad(x, (0, rw - w, 0, rh - h)), taps=_taps(taps, x.device))
    out = torch.zeros((p, 8, 8), dtype=torch.float32, device=x.device)
    out[:, 0, 0] = (blurred.double().sum(dim=(-2, -1)) * passes).float()
    return out


def blur_only(img: torch.Tensor, taps, *, passes: int = 5) -> torch.Tensor:
    """``passes`` x (11-tap row blur, then column blur) of each plane of
    ``img``, summed over the region of whole ``TILE_H`` x ``TILE_W`` tiles.

    ``img``: contiguous (B, 3, H, W) or (P, H, W) f32.  ``taps``: the
    ``Ssimulacra2`` module's (11,) f32 buffer on ``img``'s device, or
    ``taps_f32()``.  Returns (P, 8, 8) f32: the plane's total in [p, 0, 0],
    zeros elsewhere.
    """
    x = _planes(img)
    if passes < 1:
        raise ValueError(f"passes must be at least 1, got {passes}")
    taps = _taps(taps, x.device)
    if x.device.type == "cpu":
        return blur_only_ref(x, taps, passes=passes)
    if x.device.type != "cuda":
        raise ValueError(f"blur_only runs on cuda or cpu, not {x.device}")
    p, h, w = x.shape
    if not 1 <= p <= 65535:
        raise ValueError(f"the plane count must be in [1, 65535], got {p}")
    rh, rw = region(h, w)
    lib = LIBRARY.get()
    parts = torch.empty(p * lib.tm_blur_probe_blocks(rh, rw), dtype=torch.float32, device=x.device)
    out = torch.empty((p, 8, 8), dtype=torch.float32, device=x.device)
    with launch_stream(x.device) as stream:
        check(
            lib.tm_blur_probe(
                x.data_ptr(), p, h, w, rh, rw, passes, taps.data_ptr(), parts.data_ptr(),
                out.data_ptr(), stream,
            ),
            "tm_blur_probe",
        )
    blur_only.launches += 1
    return out


blur_only.launches = 0
