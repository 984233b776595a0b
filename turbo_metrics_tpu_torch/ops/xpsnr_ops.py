"""XPSNR: per-block SSE, spatial and temporal activity, and the host scoring.

The port's copy of the JAX package's ops/xpsnr_ops.py (itself the
equivalent of xpsnr_support_8/xpsnr_postprocess, xpsnr-cuda-kernel/src/
lib.rs:38-120, and the NPP highpass set-up, xpsnr-cuda/src/lib.rs:92-115).
``xpsnr_block_stats`` here runs the plain torch version or, by
``backend`` as its JAX namesake runs the Pallas kernel, the CUDA kernel #13
(ops/kernels/xpsnr.py), which computes the same grids.

The grids are uint32 in the reference and wrap mod 2^32 (the SSE of a 16x16
block can pass 2^32 at 16 bits).  torch has little uint32 arithmetic, so
every sum runs in int64 and is masked with ``& 0xFFFFFFFF``: the values are
the uint32 grids' bit for bit, held in int64 tensors.

Border note: the highpass uses edge-replicated padding (the reference's NPP
call reads out of bounds at the borders; edge replication is FFmpeg's XPSNR
behaviour).  ``xpsnr_weights`` and ``xpsnr_db`` run on the host in f64, as
they are in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import routes
from turbo_metrics_tpu_torch.utils.profiling import to_host

BLOCK = 16

# 3x3 highpass, xpsnr-cuda/src/lib.rs:67.
HIGHPASS = np.array([[-1, -2, -1], [-2, 12, -2], [-1, -2, -1]], dtype=np.int32)

U32 = 0xFFFFFFFF

def align_luma_depth(y: torch.Tensor, from_depth: int, to_depth: int) -> torch.Tensor:
    """Rescale integer luma code values between bit depths (left or right
    shift, the standard code-value mapping), so that XPSNR compares a pair
    whose inputs differ in depth at the reference's depth."""
    if from_depth == to_depth:
        return y
    y = y.to(torch.int64)
    if to_depth > from_depth:
        return y << (to_depth - from_depth)
    return y >> (from_depth - to_depth)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2, W + 2), the border replicated."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-1, h + 1, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def highpass_3x3(y: torch.Tensor) -> torch.Tensor:
    """|highpass| of an integer luma plane (..., H, W) -> int64 magnitudes."""
    x = y.to(torch.int64)
    p = _edge_pad(x)
    h, w = y.shape[-2], y.shape[-1]
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc += int(HIGHPASS[dy, dx]) * p[..., dy : dy + h, dx : dx + w]
    return acc.abs()


def block_sums(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Sum (..., H, W) int64 over block x block tiles -> (..., ceil(H/b),
    ceil(W/b)), mod 2^32.  Edge tiles sum only their valid pixels (the
    reference's bounds check, kernel lib.rs:65-67)."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % block, (-w) % block
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, pw, 0, ph))
    hb, wb = (h + ph) // block, (w + pw) // block
    x = x.reshape(*x.shape[:-2], hb, block, wb, block)
    return x.sum(dim=(-3, -1)) & U32


def kernel_ok(y_ref, y_dis, y_prev, block: int, backend) -> bool:
    """Whether the inputs take #13 under ``backend``: the resolved route is
    the kernel's, the blocks are its 16x16, the planes are (B, h, w) of its
    types (y_ref and y_prev of one).  JAX's further gates, min(h, w) >= 32
    and depth <= 12 (ops/xpsnr_ops.py), keep its Pallas kernel's f32 block
    sums exact and its tiles whole; #13 sums in uint32 at any size and depth
    (its edge cases from 1 row and 15 columns up), so it keeps neither."""
    from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES

    if not routes.kernel_route(backend, y_ref.device):
        return False
    return (block == BLOCK and y_ref.ndim == 3 and y_dis.shape == y_prev.shape == y_ref.shape
            and y_ref.dtype in DTYPE_CODES and y_dis.dtype in DTYPE_CODES and y_prev.dtype == y_ref.dtype)


def xpsnr_block_stats(
    y_ref: torch.Tensor,
    y_dis: torch.Tensor,
    y_prev: torch.Tensor,
    *,
    block: int = BLOCK,
    depth: int = 8,
    backend: str | None = None,
) -> dict[str, torch.Tensor]:
    """Per-block SSE / spatial activity / temporal activity.

    Inputs: integer luma planes (..., H, W); ``y_prev`` is the previous
    *reference* frame (for the first frame, the frame itself -> tact 0).
    Returns the uint32 block grids (kernel lib.rs:69-91) as int64 tensors.
    ``backend`` (ops/routes.py): #13 with a per-frame ``prev`` where
    ``kernel_ok``, else the plain version; the grids are the same bit for
    bit.  ``depth`` is the JAX signature's; neither route reads it.
    """
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be 1-16 bits, got {depth}")
    if kernel_ok(y_ref, y_dis, y_prev, block, backend):
        from turbo_metrics_tpu_torch.ops.kernels import xpsnr

        return xpsnr.xpsnr_block_stats(y_ref.contiguous(), y_dis.contiguous(), prev=y_prev.contiguous())
    r = y_ref.to(torch.int64)
    d = y_dis.to(torch.int64)
    p = y_prev.to(torch.int64)
    err = r - d
    return {
        "sse": block_sums((err * err) & U32, block),
        "sact": block_sums(highpass_3x3(y_ref), block),
        "tact": block_sums((r - p).abs(), block),
    }


def xpsnr_weights(
    sse: np.ndarray,
    sact: np.ndarray,
    tact: np.ndarray,
    *,
    width: int,
    height: int,
    depth: int = 8,
    block: int = BLOCK,
) -> tuple[float, np.ndarray]:
    """Host-side f64 weighting + final wsse (xpsnr-cuda/src/lib.rs:116-196).

    ``sse``/``sact``/``tact``: (hb, wb) block grids for one frame.
    Returns (wsse_final, weights).  Small frames (<= VGA) get the neighbour
    weight smoothing of the reference's CPU path (lib.rs:135-166).
    """
    sse = sse.astype(np.float64).reshape(-1)
    sact = sact.astype(np.float64).reshape(-1)
    tact = tact.astype(np.float64).reshape(-1)
    nsamples = float(block * block)
    msact = 1.0 + sact / nsamples + 2.0 * tact / nsamples
    msact = np.maximum(msact, float(1 << (depth - 2)))
    weights = 1.0 / msact

    num_blocks = sse.size
    blocks_w = (width + block - 1) // block
    if width * height <= 640 * 480:
        w = weights
        for blk in range(num_blocks):
            if blk % blocks_w == 0:  # first column
                msact_prev = w[blk - 2] if blk > 1 else 0.0
            else:
                if blk % blocks_w > 1:
                    msact_prev = max(w[blk - 2], w[blk])
                else:
                    msact_prev = w[blk]
            if blk > blocks_w:
                msact_prev = max(msact_prev, w[blk - 1 - blocks_w])
            if blk > 0 and w[blk - 1] > msact_prev:
                w[blk - 1] = msact_prev
            if blk == num_blocks - 1 and blk > 0:
                msact_prev = max(w[blk - 1], w[blk - blocks_w])
                w[blk] = min(w[blk], msact_prev)
        weights = w

    wsse = float((weights * sse).sum())
    if wsse < 0.0:
        return 0.0, weights
    r = width * height / (3840.0 * 2160.0)
    avgact = np.sqrt(16.0 * float(1 << (2 * depth - 9)) / np.sqrt(max(r, 0.00001)))
    return float(np.uint64(wsse * avgact + 0.5)), weights


def xpsnr_db(wsse_final: float, *, width: int, height: int, depth: int = 8) -> float:
    """Weighted SSE -> XPSNR in dB."""
    if wsse_final <= 0.0:
        return float("inf")
    maxval = (1 << depth) - 1
    return 10.0 * np.log10((maxval * maxval) * float(width * height) / wsse_final)


def frames_db(stats: dict, *, width: int, height: int, depth: int = 8) -> list[float]:
    """XPSNR in dB of each frame of a batch's block grids ({"sse", "sact",
    "tact"}: (B, hb, wb) tensors or arrays), on the host."""
    g = {k: to_host(v) if torch.is_tensor(v) else np.asarray(v) for k, v in stats.items()}
    kw = dict(width=width, height=height, depth=depth)
    return [
        xpsnr_db(xpsnr_weights(g["sse"][i], g["sact"][i], g["tact"][i], **kw)[0], **kw)
        for i in range(g["sse"].shape[0])
    ]
