"""XPSNR of luma codes (Helmrich et al., the structure of turbo-metrics'
xpsnr-cuda): per 16 x 16 block the squared error, the spatial activity
(the |3x3 highpass| of the reference, its border replicated) and the
temporal activity (|reference - previous reference|); the weights
1 / max(1 + (sact + 2 tact) / 256, 2^(depth - 2)), with the neighbour
smoothing of frames no larger than 640 x 480; the weighted error scaled by
the mean activity of a 3840 x 2160 frame, rounded, and turned into dB.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 16
HIGHPASS = ((-1, -2, -1), (-2, 12, -2), (-1, -2, -1))


def _block_sums(x: torch.Tensor, sum_dtype: torch.dtype) -> torch.Tensor:
    """(B, h, w) -> (B, hb * wb) sums of 16 x 16 blocks (partial at the edge)."""
    bsz, h, w = x.shape
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)
    x = torch.nn.functional.pad(x.to(sum_dtype), (0, wb * BLOCK - w, 0, hb * BLOCK - h))
    return x.reshape(bsz, hb, BLOCK, wb, BLOCK).sum(dim=(2, 4)).reshape(bsz, -1)


def _weights(sse, sact, tact, h: int, w: int, depth: int) -> np.ndarray:
    n = sse.dtype.type(BLOCK * BLOCK)
    one = sse.dtype.type(1.0)
    weights = one / np.maximum(one + sact / n + 2 * tact / n, sse.dtype.type(1 << (depth - 2)))
    if w * h > 640 * 480:
        return weights
    blocks_w, nb = -(-w // BLOCK), weights.size
    wgt = weights.copy()
    for blk in range(nb):
        if blk % blocks_w == 0:
            prev = wgt[blk - 2] if blk > 1 else 0.0
        elif blk % blocks_w > 1:
            prev = max(wgt[blk - 2], wgt[blk])
        else:
            prev = wgt[blk]
        if blk > blocks_w:
            prev = max(prev, wgt[blk - 1 - blocks_w])
        if blk > 0 and wgt[blk - 1] > prev:
            wgt[blk - 1] = prev
        if blk == nb - 1 and blk > 0:
            wgt[blk] = min(wgt[blk], max(wgt[blk - 1], wgt[blk - blocks_w]))
    return wgt


def xpsnr(y_ref: torch.Tensor, y_dis: torch.Tensor, y_prev: torch.Tensor, *, depth: int, dtype: torch.dtype,
          sum_dtype: torch.dtype) -> np.ndarray:
    """(B, h, w) luma codes at ``depth`` bits (the distorted already at the
    reference's depth) and each frame's previous reference -> (B,) dB.  The
    block grids in ``dtype`` with ``sum_dtype`` sums, the weighting in
    ``sum_dtype`` too (float64 for the reference)."""
    h, w = y_ref.shape[-2:]
    r, d, p = (t.to(dtype) for t in (y_ref, y_dis, y_prev))
    e = r - d
    rp = torch.nn.functional.pad(r[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    hp = sum(HIGHPASS[i][j] * rp[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    host = np.float64 if sum_dtype == torch.float64 else np.float32
    sse = _block_sums(e * e, sum_dtype).cpu().numpy().astype(host)
    sact = _block_sums(hp.abs(), sum_dtype).cpu().numpy().astype(host)
    tact = _block_sums((r - p).abs(), sum_dtype).cpu().numpy().astype(host)
    rr = w * h / (3840.0 * 2160.0)
    avgact = np.sqrt(16.0 * float(1 << (2 * depth - 9)) / np.sqrt(max(rr, 1e-5)))
    top = (1 << depth) - 1
    out = []
    for i in range(sse.shape[0]):
        wsse = float((_weights(sse[i], sact[i], tact[i], h, w, depth) * sse[i]).sum())
        wsse = float(np.floor(wsse * avgact + 0.5))
        out.append(float("inf") if wsse <= 0.0 else 10.0 * np.log10(top * top * float(w * h) / wsse))
    return np.array(out)
