"""Gaussian blur used by SSIMULACRA2, as an exact 11-tap separable FIR.

The canonical SSIMULACRA2 blur is a recursive Gaussian built from truncated
cosines (Charalampidis 2016) at sigma = 1.5 (reference:
ssimulacra2-cuda/examples/cpu.rs:950-1116, constants at :931-948).  That
recursion is an exact FIR filter of radius 5: its oscillators cancel outside
a window of 11 taps.  The taps are derived numerically from the recurrence
in f64 and applied as shifted adds, zero-extended at the border with no
renormalisation, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Filter recurrence constants (f32 values from the canonical implementation,
# ssimulacra2-cuda/examples/cpu.rs:931-948), widened to f64.
RADIUS = 5
_MUL_IN = np.float32([0.055295236, -0.058836687, 0.012955819]).astype(np.float64)
_MUL_PREV = np.float32([1.9021131, 1.1755705, 1.2246469e-16]).astype(np.float64)


def _impulse_response(length: int = 4096) -> np.ndarray:
    """Run the reference recurrence on a unit impulse, in f64."""
    center = length // 2
    x = np.zeros(length, dtype=np.float64)
    x[center] = 1.0
    out = np.zeros(length, dtype=np.float64)
    prev = np.zeros(3, dtype=np.float64)
    prev2 = np.zeros(3, dtype=np.float64)
    for n in range(-RADIUS + 1, length):
        left = n - RADIUS - 1
        right = n + RADIUS - 1
        s = (x[left] if left >= 0 else 0.0) + (x[right] if 0 <= right < length else 0.0)
        cur = s * _MUL_IN + _MUL_PREV * prev - prev2
        prev2, prev = prev, cur
        if n >= 0:
            out[n] = cur.sum()
    return out, center


@functools.lru_cache(maxsize=None)
def gaussian_taps() -> np.ndarray:
    """The 11 FIR taps equivalent to the reference recursive Gaussian (f64).

    Also asserts that the truncation residual (the tiny undamped oscillation
    left over because the reference's constants are f32-rounded) is negligible.
    """
    h, center = _impulse_response(length=512)
    taps = h[center - RADIUS : center + RADIUS + 1].copy()
    tail = np.concatenate([h[: center - RADIUS], h[center + RADIUS + 1 :]])
    # The oscillator cancellation is imperfect because the recurrence
    # constants are f32-rounded: a zero-mean tail of amplitude ~1.4e-7
    # persists.  It integrates to ~0 against any signal, so truncating it is
    # safe; this only guards against gross derivation bugs.
    assert np.abs(tail).max() < 1e-6, "recursive-gaussian tail unexpectedly large"
    return taps


def taps_f32(taps=None) -> list[float]:
    """The taps rounded to f32, as Python floats (exactly representable)."""
    if taps is None:
        taps = gaussian_taps()
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return [float(v) for v in np.asarray(taps).astype(np.float32)]


def blur_2d(x: torch.Tensor, *, taps=None) -> torch.Tensor:
    """Separable 11-tap blur over the last two axes, zero-extended.

    Horizontal pass first, then vertical, each a sum of shifted products in
    tap order (the same order as the JAX package's ``blur_2d``).  Built from
    elementwise ops only: no convolution library call, so no TF32.
    """
    t = taps_f32(taps)
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (RADIUS, RADIUS))
    acc = t[0] * xp[..., :, 0:w_dim]
    for k in range(1, 2 * RADIUS + 1):
        acc = acc + t[k] * xp[..., :, k : k + w_dim]
    xp = F.pad(acc, (0, 0, RADIUS, RADIUS))
    acc = t[0] * xp[..., 0:h_dim, :]
    for k in range(1, 2 * RADIUS + 1):
        acc = acc + t[k] * xp[..., k : k + h_dim, :]
    return acc


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Sampled (true) Gaussian window, normalised to sum 1 (f64).

    The window of the classic SSIM / MS-SSIM metrics (Wang et al.), *not*
    SSIMULACRA2's blur (:func:`gaussian_taps`).
    """
    half = (size - 1) / 2.0
    g = np.exp(-((np.arange(size) - half) ** 2) / (2.0 * sigma**2))
    return g / g.sum()
