"""Kernel #18: ADM's four levels of DWT, decoupling, CSF, masking and cube
sums.

``adm_stats`` launches ``tm_adm_level`` (csrc/adm.cu) once per level on a
CUDA tensor, each level reading the approximation bands the one before
wrote, and runs its plain twin ``adm_stats_ref`` (ops/adm.py) on a CPU
tensor.  It replaces the JAX package's ``_adm_level_run``
(turbo_metrics_tpu/ops/pallas/adm.py:442) behind ``adm_stats_pallas``
(l.420), with the math of the JAX package's jnp path (ops/adm.py), which the
JAX engine runs.  A level is one fused tile kernel and the f64 reduction of
its partials: the row-filtered and band planes stay in shared memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import adm
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import PART_H, PART_W
from turbo_metrics_tpu_torch.ops.kernels.vif import check_pair

_TAPS = (ctypes.c_float * 8)(*np.concatenate([adm.DB2_LO, adm.DB2_HI]).astype(np.float32))


def adm_stats_ref(pair):
    """Plain twin of ``adm_stats`` (same argument and result)."""
    check_pair(pair)
    return adm.adm_stats(pair[0], pair[1])


def adm_blocks(ch: int, cw: int, top: int, left: int) -> int:
    """Partial blocks per frame of a ch x cw band plane: the 32x8 blocks
    (PART_W x PART_H) of its centre region [top, ch-top) x [left, cw-left),
    the count of ``tm_adm_blocks`` (csrc/adm.cu)."""
    return -(-(cw - 2 * left) // PART_W) * -(-(ch - 2 * top) // PART_H)


def level_scratch(bsz: int, h: int, w: int, dev) -> torch.Tensor:
    """The six f32 partials of every 32x8 centre-region block of B frames of
    an h x w level input: a level's only scratch, since the tile kernel
    keeps its row-filtered and band planes in shared memory."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    top, _, left, _ = adm.center_region(ch, cw)
    return torch.empty(bsz * adm_blocks(ch, cw, top, left) * 6, dtype=torch.float32, device=dev)


def adm_stats(pair: torch.Tensor) -> torch.Tensor:
    """Per-level, per-band centre-region cube sums of a (2, B, h, w) f32
    (reference, distorted) luma pair in 8-bit units -> (B, 4, 3, 2) f32:
    [..., band, 0] = sum |masked csf*r|^3, [..., band, 1] = sum |csf*o|^3,
    bands (H, V, D)."""
    check_pair(pair)
    if pair.device.type == "cpu":
        return adm_stats_ref(pair)
    if pair.device.type != "cuda":
        raise ValueError(f"adm_stats runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    _, bsz, h, w = pair.shape
    dev = pair.device
    sums = torch.empty((bsz, adm.NUM_LEVELS, 3, 2), dtype=torch.float32, device=dev)
    x = pair
    with launch_stream(dev) as stream:
        for level in range(adm.NUM_LEVELS):
            ch, cw = (h + 1) // 2, (w + 1) // 2
            top, _, left, _ = adm.center_region(ch, cw)
            last = level + 1 == adm.NUM_LEVELS
            approx = None if last else torch.empty((2, bsz, ch, cw), dtype=torch.float32, device=dev)
            parts = level_scratch(bsz, h, w, dev)
            rf_hv, rf_d = adm.csf_rfactors(level)
            check(
                lib.tm_adm_level(
                    x.data_ptr(), bsz, h, w, _TAPS, float(np.float32(rf_hv)), float(np.float32(rf_d)),
                    float(np.float32(adm.COS_1DEG_SQ)), float(np.float32(adm.DECOUPLE_EPS)),
                    float(adm.MASK_CENTRE), float(adm.MASK_EDGE), top, left,
                    approx.data_ptr() if approx is not None else None, parts.data_ptr(),
                    sums[:, level].data_ptr(), adm.NUM_LEVELS * 6, stream,
                ),
                "tm_adm_level",
            )
            x, h, w = approx, ch, cw
    adm_stats.launches += 1
    return sums


adm_stats.launches = 0
