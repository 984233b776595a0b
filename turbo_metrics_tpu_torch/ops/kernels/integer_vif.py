"""K-int-VIF: VIF's four scales under the fixed-point conventions.

``integer_vif_stats`` launches ``tm_integer_vif_level`` (csrc/integer_vif.cu)
once per scale on a CUDA tensor, each scale reading the uint16 input the one
before emitted (uint8 codes through the kernel's narrow instances,
``narrow_codes``), and runs its plain twin ``integer_vif_stats_ref``
(ops/integer_vif.py) on a CPU tensor.  No TPU kernel stands behind it: the
JAX package computes ``integer_vif_stats`` (turbo_metrics_tpu/ops/
integer_vif.py:100) with jnp.  ``integer_vif_planes`` runs the same launches
with the kernel's check stores on, for holding its integer planes against
``integer_vif_planes_ref`` bit for bit.

``columns=(lo, hi)``: the owned level-0 columns whose log2 terms are summed
(None: all of them).  Scale k sums its columns j with lo <= j * 2^k < hi,
``vif.scale_columns``: [ceil(lo / 2^k), ceil(hi / 2^k)).  Every plane is
still blurred and emitted whole.

Width sharding (ops/kernels/vif.py ``vif_width_sharded``, which
parallel/mesh.py ``shard_over_width`` calls for this entry too): the float
VIF's plan, A = 8 and H = 24, holds here, derived from this schedule
(ops/integer_vif.py) rather than taken over:
  * scale k's input is (sum C2 vx + 2^19) >> 20 at the even rows and
    columns, vx the vertical pass of scale k's own C1 over scale k - 1's
    input: the blur of window k (radius r_k = 8, 4, 2, 1), decimated, as
    the float path's decimate2(blur(x, window k)); its map blurs scale k's
    input with window k again (C1 then C2, both of radius r_k).  The
    pre-rounding of codes above 8 bits is per sample.  Borders are
    reflect-101 at every scale;
  * A: a strip starting at a multiple of 2^3 decimates in the frame's
    phase at every scale, so its scale-k column j is the frame's column
    lo / 2^k + j, and the last strip's right edge is the frame's at every
    scale (the same reflections);
  * H: an owned pixel of scale k (level-0 column 2^k j >= own_lo) reads
    scale-k columns j - r_k .., which read scale k - 1 columns 2 (j - r_k)
    - r_k = 2 j - 3 r_k .., and so on down: 8, 2 * 4 + 4 = 12, 4 * 2 + 2 *
    2 + 4 = 16 and 8 + 4 + 4 + 4 = 20 level-0 columns to the left at scales
    0-3; to the right, from the last owned pixel (2^k j <= own_hi - 2^k),
    up to own_hi + 12.  Samples that a strip's cut reflects at its inner
    edge reach no owned pixel: H = 20 rounded up to a multiple of A;
  * the strips' f32 (B, 4, 2) sums add in f64 and round once to f32, and a
    strip keeps the codes' dtype (uint8 codes stay on the narrow
    instances).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import integer_vif
from turbo_metrics_tpu_torch.ops import vif as vif_ops
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.kernels.vif import vif_blocks
from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES
from turbo_metrics_tpu_torch.ops.vif import NUM_SCALES

PLANES = ("s11", "s22", "s12", "mu1", "mu2")
_COEFFS: dict = {}


def _coeffs(scale: int):
    """C1, C2 of the scale's window, then C1, C2 of the next scale's (host
    int32 for the kernel's parameters, made once)."""
    if scale not in _COEFFS:
        parts = [integer_vif.vif_coeffs_q(k, bits) for k in (scale, scale + 1)
                 if k < NUM_SCALES for bits in (16, 12)]
        taps = np.concatenate(parts).astype(np.int32).tolist()
        _COEFFS[scale] = (ctypes.c_int * len(taps))(*taps)
    return _COEFFS[scale]


def narrow_codes(pair: torch.Tensor) -> bool:
    """Whether the kernel's narrow instances take ``pair``: uint8 codes, at
    any depth (pre-rounded, a code stays <= 128), so that every scale's
    samples are < 2^8 and its vertical sums < 2^16 (csrc/integer_vif.cu)."""
    return pair.dtype == torch.uint8


def check_codes(pair):
    """Raise unless ``pair`` is a contiguous (2, B, h, w) pair of uint8,
    uint16 or int32 luma codes (the input of the integer VIF and ADM)."""
    if pair.ndim != 4 or pair.shape[0] != 2:
        raise ValueError(f"pair must be (2, B, h, w), got {tuple(pair.shape)}")
    if pair.dtype not in DTYPE_CODES or not pair.is_contiguous():
        raise ValueError(f"pair must be contiguous uint8, uint16 or int32 codes, got {pair.dtype}")


def pre_shift(depth: int) -> int:
    """The pre-rounding shift of codes at ``depth`` bits to 8 bits."""
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be 1-16 bits, got {depth}")
    return max(depth - 8, 0)


def integer_vif_stats_ref(pair, *, depth=8, columns=None):
    """Plain twin of ``integer_vif_stats`` (same arguments and result)."""
    check_codes(pair)
    pre_shift(depth)
    return integer_vif.integer_vif_stats(pair[0], pair[1], depth=depth, columns=columns)


def integer_vif_planes_ref(pair, *, depth=8):
    """Plain twin of ``integer_vif_planes``."""
    check_codes(pair)
    pre_shift(depth)
    return integer_vif.integer_vif_scale_planes(pair[0], pair[1], depth=depth)


def _run(pair, depth, planes: bool, columns=None):
    check_codes(pair)
    shift = pre_shift(depth)
    if pair.device.type != "cuda":
        raise ValueError(f"integer VIF runs on cuda or cpu, not {pair.device}")
    lib = LIBRARY.get()
    _, bsz, h, w = pair.shape
    dev = pair.device
    narrow = int(narrow_codes(pair))
    sums = torch.empty((bsz, NUM_SCALES, 2), dtype=torch.float32, device=dev)
    out, x = [], pair
    with launch_stream(dev) as stream:
        for k in range(NUM_SCALES):
            nxt = None
            if k + 1 < NUM_SCALES:
                nxt = torch.empty((2, bsz, (h + 1) // 2, (w + 1) // 2), dtype=torch.uint16, device=dev)
            moments = torch.empty((5, bsz, h, w), dtype=torch.int32, device=dev) if planes else None
            parts = torch.empty(bsz * vif_blocks(h, w) * 2, dtype=torch.float32, device=dev)
            clo, chi = vif_ops.window_columns(vif_ops.scale_columns(columns, k), w)
            check(
                lib.tm_integer_vif_level(
                    x.data_ptr(), DTYPE_CODES[x.dtype], narrow, bsz, h, w, k, shift if k == 0 else 0, clo, chi,
                    _coeffs(k), parts.data_ptr(), sums[:, k].data_ptr(), NUM_SCALES * 2,
                    None if nxt is None else nxt.data_ptr(), None if moments is None else moments.data_ptr(),
                    stream,
                ),
                "tm_integer_vif_level",
            )
            integer_vif_stats.launches += 1
            if planes:
                out.append(dict(zip(PLANES, moments.unbind(0))))
                if k > 0:
                    out[-1].update(ref=x[0].to(torch.int32), dis=x[1].to(torch.int32))
            x = nxt
            if nxt is not None:
                h, w = nxt.shape[-2:]
    return sums, out


def integer_vif_stats(pair: torch.Tensor, *, depth: int = 8, columns=None) -> torch.Tensor:
    """Per-scale (num, den) sums of a (2, B, h, w) pair of (reference,
    distorted) luma codes at ``depth`` bits under the fixed-point
    conventions -> (B, 4, 2) f32; ``columns``: the owned level-0 columns
    (module docstring; None: all)."""
    if pair.device.type == "cpu":
        return integer_vif_stats_ref(pair, depth=depth, columns=columns)
    return _run(pair, depth, False, columns)[0]


integer_vif_stats.launches = 0


def integer_vif_planes(pair: torch.Tensor, *, depth: int = 8) -> list[dict]:
    """The integer planes of every scale, from the kernel's check stores:
    per scale s11, s22, s12, mu1, mu2 ((B, h, w) int32) and, from scale 1
    on, the scale's input ('ref', 'dis').  Counts its launches with
    ``integer_vif_stats``; not on the main path."""
    if pair.device.type == "cpu":
        return integer_vif_planes_ref(pair, depth=depth)
    return _run(pair, depth, True)[1]
