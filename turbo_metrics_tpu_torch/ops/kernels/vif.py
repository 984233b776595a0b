"""Kernels #14 and #15: VIF's scale 0, and scales 1-3.

``vif_scale0`` (#14) and ``vif_tail`` (#15) launch ``tm_vif_level``
(csrc/vif.cu) on CUDA tensors, once at scale 0 and once at each of scales
1-3; on CPU tensors they run their plain twins (``vif_scale0_ref``,
``vif_tail_ref``).  They replace the JAX package's ``_vif_scale_pallas``
(turbo_metrics_tpu/ops/pallas/vif.py:540) as ``vif_scale_stats_pallas``
(l.664) runs it at scale 0, and ``vif_tail_pallas`` (ops/pallas/vif_tail.py:
331).  Scale k's input is decimate2(blur(x, window k)) of scale k - 1
(ops/vif.py), so the launch at scale k - 1 emits it with the next window.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import vif
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W

_WINDOWS: dict = {}


def _window(scale: int, device) -> torch.Tensor:
    """The f32 taps of a scale's window on ``device`` (made once)."""
    key = (scale, str(device))
    if key not in _WINDOWS:
        _WINDOWS[key] = torch.from_numpy(vif.vif_window(scale).astype(np.float32)).to(device)
    return _WINDOWS[key]


def check_pair(pair):
    """Raise unless ``pair`` is a contiguous f32 (2, B, h, w) luma pair (the
    input of VIF and ADM)."""
    if pair.ndim != 4 or pair.shape[0] != 2:
        raise ValueError(f"pair must be (2, B, h, w), got {tuple(pair.shape)}")
    if pair.dtype != torch.float32 or not pair.is_contiguous():
        raise ValueError(f"pair must be contiguous float32, got {pair.dtype}")


def _emit(x, scale):
    return vif.decimate2(vif.blur_same(x, vif.vif_window(scale))).contiguous()


def vif_scale0_ref(pair):
    """Plain twin of ``vif_scale0`` (same argument and results)."""
    check_pair(pair)
    return vif.scale_sums(pair[0], pair[1], vif.vif_window(0)), _emit(pair, 1)


def vif_tail_ref(level1):
    """Plain twin of ``vif_tail`` (same argument and result)."""
    check_pair(level1)
    out, x = [], level1
    for k in range(1, vif.NUM_SCALES):
        out.append(vif.scale_sums(x[0], x[1], vif.vif_window(k)))
        if k + 1 < vif.NUM_SCALES:
            x = _emit(x, k + 1)
    return torch.stack(out, dim=1)


def vif_blocks(h: int, w: int) -> int:
    """Partial tiles per frame of an h x w scale: its 32x8 tiles (PART_W x
    PART_H), the count of ``tm_vif_blocks`` (csrc/vif.cu)."""
    return -(-w // PART_W) * -(-h // PART_H)


def level_scratch(bsz: int, h: int, w: int, dev) -> torch.Tensor:
    """The two f32 partials of every 32x8 tile of B frames of an h x w
    scale: a scale's only scratch, since the tile kernel keeps its
    row-blurred planes (and the next scale's rows) in shared memory."""
    return torch.empty(bsz * vif_blocks(h, w) * 2, dtype=torch.float32, device=dev)


def _launch(lib, x, scale, sums, sums_pstride, nxt):
    """One ``tm_vif_level`` call on the current stream."""
    _, bsz, h, w = x.shape
    dev = x.device
    parts = level_scratch(bsz, h, w, dev)
    win_e = None if nxt is None else _window(scale + 1, dev).data_ptr()
    with launch_stream(dev) as stream:
        check(
            lib.tm_vif_level(
                x.data_ptr(), bsz, h, w, scale, _window(scale, dev).data_ptr(), win_e, parts.data_ptr(),
                sums.data_ptr(), sums_pstride, None if nxt is None else nxt.data_ptr(),
                stream,
            ),
            "tm_vif_level",
        )


def _next_level(x):
    _, bsz, h, w = x.shape
    return torch.empty((2, bsz, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=x.device)


def vif_scale0(pair: torch.Tensor):
    """VIF scale 0 of a (2, B, h, w) f32 (reference, distorted) luma pair in
    8-bit units -> ((B, 2) f32 (num, den) sums, the (2, B, ceil(h/2),
    ceil(w/2)) f32 input of scale 1)."""
    check_pair(pair)
    if pair.device.type == "cpu":
        return vif_scale0_ref(pair)
    if pair.device.type != "cuda":
        raise ValueError(f"vif_scale0 runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    sums = torch.empty((pair.shape[1], 2), dtype=torch.float32, device=pair.device)
    level1 = _next_level(pair)
    _launch(lib, pair, 0, sums, 2, level1)
    vif_scale0.launches += 1
    return sums, level1


vif_scale0.launches = 0


def vif_tail(level1: torch.Tensor) -> torch.Tensor:
    """VIF scales 1-3 from scale 1's (2, B, h, w) f32 input (``vif_scale0``'s
    second result) -> (B, 3, 2) f32 (num, den) sums."""
    check_pair(level1)
    if level1.device.type == "cpu":
        return vif_tail_ref(level1)
    if level1.device.type != "cuda":
        raise ValueError(f"vif_tail runs on cuda or cpu, not {level1.device}")
    lib = LIBRARY.get()
    nscales = vif.NUM_SCALES - 1
    sums = torch.empty((level1.shape[1], nscales, 2), dtype=torch.float32, device=level1.device)
    x = level1
    for k in range(1, vif.NUM_SCALES):
        nxt = _next_level(x) if k + 1 < vif.NUM_SCALES else None
        _launch(lib, x, k, sums[:, k - 1], nscales * 2, nxt)
        x = nxt
    vif_tail.launches += 1
    return sums


vif_tail.launches = 0


def vif_scale_stats(pair: torch.Tensor) -> torch.Tensor:
    """All four scales' (num, den) sums of a (2, B, h, w) f32 pair -> (B, 4,
    2) f32, through #14 and #15 (their twins on the CPU)."""
    sums0, level1 = vif_scale0(pair)
    return torch.cat([sums0[:, None], vif_tail(level1)], dim=1)
