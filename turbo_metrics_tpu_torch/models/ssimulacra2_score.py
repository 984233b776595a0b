"""SSIMULACRA2 final scoring: 108 tuned weights + output nonlinearity.

The weighted sum over (3 channels x 6 scales x 2 norms x 3 maps) sub-scores
and the cubic + power nonlinearity follow the published SSIMULACRA 2.1
algorithm (reference: ssimulacra2-cuda/examples/cpu.rs:728-871, host
post-processing ssimulacra2-cuda/src/lib.rs:449-623).  This runs on the host
in f64 — it is 108 multiply-adds per frame.
"""

from __future__ import annotations

import numpy as np

# fmt: off
WEIGHTS = np.array([
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346, 0.00066284834129271,
    0.00015231632783718752, 0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0, 0.0007989109436015163,
    0.000176816438078653, 0.0, 1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0, 0.00014003424285435884,
    0.9981766977854967, 0.00031949755934435053, 0.0004550992113792063, 0.0,
    0.0, 0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016, 0.0011401524586618361,
    0.001237755635509985, 176.39317598450694, 0.0, 0.0, 24.43300999870476,
    0.28520802612117757, 0.0004485436923833408, 0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862, 23.19243343998926,
    0.0, 95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379, 0.0, 0.0,
    0.0, 0.0005130064588990679, 0.0, 0.00010854057858411537,
], dtype=np.float64)
# fmt: on
assert WEIGHTS.shape == (108,)


def weight_needs(n_scales: int) -> tuple:
    """Static per-scale work masks from the zero structure of WEIGHTS.

    Only 52 of the 108 tuned weights are nonzero, so 56 of the
    (channel, scale, norm, map) sub-scores never influence the final score
    — the device kernels can skip computing them EXACTLY (the skipped
    entries are emitted as 0, and 0 x 0-weight == anything x 0-weight).
    At scale 0 this drops the modified-SSIM map (and with it the three
    product blurs, their limb splits and both divides) on two of the three
    XYB channels and 13 of the 18 sum reductions; at the last scale the
    artifact map disappears entirely and one channel is fully dead.

    Returns a tuple of ``n_scales`` entries, each a per-channel 6-tuple of
    bools over the kernels' sum order (d, d^4, art, art^4, det, det^4) —
    i.e. ``needs[s][c][2*m + n] == (WEIGHTS[c, s, n, m] != 0)`` under the
    contiguous per-channel weight consumption postprocess_score applies
    when fewer than 6 scales are computed.  Fully hashable (usable as a
    static jit/pallas argument).
    """
    assert 1 <= n_scales <= 6
    w = WEIGHTS[: 3 * n_scales * 6].reshape(3, n_scales, 2, 3)
    return tuple(
        tuple(
            tuple(bool(w[c, s, k % 2, k // 2] != 0.0) for k in range(6))
            for c in range(3)
        )
        for s in range(n_scales)
    )


def needs_mask(n_scales: int) -> np.ndarray:
    """(3, n_scales, 2, 3) f32 0/1 mask of nonzero-weighted sub-scores —
    the dense-array counterpart of weight_needs for the jnp backends."""
    w = WEIGHTS[: 3 * n_scales * 6].reshape(3, n_scales, 2, 3)
    return (w != 0.0).astype(np.float32)


def postprocess_score(vals: np.ndarray, weights: np.ndarray = WEIGHTS) -> np.ndarray:
    """Sub-scores -> final SSIMULACRA2 score(s), all in f64.

    ``vals``: (..., 3, S, 2, 3) array of per-(channel, scale, norm, map)
    sub-scores, S <= 6 scales.  When fewer than 6 scales were computed, the
    weight stream is consumed contiguously per channel — matching the
    reference's flat iteration (examples/cpu.rs:843-854).  ``weights``: the
    108 weights (the ``Ssimulacra2`` module passes its buffer).

    Returns scores of shape (...,).
    """
    vals = np.abs(np.asarray(vals, dtype=np.float64))
    *lead, c, s, n, m = vals.shape
    assert (c, n, m) == (3, 2, 3) and 1 <= s <= 6
    w = np.asarray(weights, dtype=np.float64)[: 3 * s * 6].reshape(3, s, 2, 3)
    ssim = np.einsum("...csnm,csnm->...", vals, w)

    ssim = ssim * 0.9562382616834844
    ssim = (
        6.248496625763138e-5 * ssim * ssim * ssim
        + 2.326765642916932 * ssim
        - 0.020884521182843837 * ssim * ssim
    )
    score = np.where(ssim > 0.0, 100.0 - 10.0 * np.power(np.maximum(ssim, 0.0), 0.6276336467831387), 100.0)
    return score if score.ndim else float(score)
