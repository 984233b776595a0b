"""The comparison that decides a run's ``correct``.

Once the window has closed, a sample of the frames whose scores the window
returned, drawn from the seed in equal shares from every slot of the batch
(so that a fault in one slot cannot slip past), is scored again by the plain reference
(reference/) from the same raw planes, each frame with its own previous
reference frame in the stream; per family the widest gap between the
program's per-frame values and the reference's is held to the cell's
limit.  The reference runs on the run's device in blocks of a few frames,
after the program's state has been freed.
"""

from __future__ import annotations

import math
import random

import numpy as np

from portbench.reference.scores import FAMILY_KEYS, families, frame_scores

BLOCK = 4


def sample(answers: list, n: int, seed: int, batch: int) -> list:
    """``n`` of the window's answers, (stream index, values), drawn from the
    seed: n // batch from each slot of the batch (stream index modulo
    ``batch``), one more from n % batch slots drawn first, all of a slot
    that holds fewer."""
    rng = random.Random(f"sample-{seed}")
    slots = [[a for a in answers if a[0] % batch == j] for j in range(batch)]
    extra = set(rng.sample(range(batch), n % batch))
    picked = []
    for j, own in enumerate(slots):
        picked += rng.sample(own, min(n // batch + (j in extra), len(own)))
    return sorted(picked, key=lambda a: a[0])


def reference_values(ring, stream_idx: list[int], metrics, *, control: bool = False) -> dict:
    """The reference's (or with ``control`` the control's) per-frame values
    of the stream's frames ``stream_idx``, as arrays in that order."""
    out: dict = {}
    for i in range(0, len(stream_idx), BLOCK):
        ts = stream_idx[i:i + BLOCK]
        frames = [t % ring.frames for t in ts]
        prevs = [(t - 1) % ring.frames if t else t for t in ts]
        ref, dis = ring.frame_planes(frames)
        prev_luma = ring.frame_planes(prevs)[0][0]
        vals = frame_scores(ref, dis, prev_luma, ring.fmt_ref, ring.fmt_dis, metrics, control=control)
        for k, v in vals.items():
            out.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in out.items()}


def gaps(program: dict, reference: dict, metrics) -> dict:
    """Per family the widest |program - reference| over the frames and the
    family's values (inf where a value is missing or not finite)."""
    out = {}
    for fam in families(metrics):
        worst = 0.0
        for key in FAMILY_KEYS[fam]:
            p = np.asarray(program.get(key, [math.nan]), dtype=np.float64)
            r = np.asarray(reference.get(key, [math.nan]), dtype=np.float64)
            d = np.abs(p - r) if p.shape == r.shape else np.array([math.inf])
            worst = max(worst, float(np.max(np.where(np.isfinite(d), d, math.inf))))
        out[fam] = worst
    return out


def program_values(picked: list) -> dict:
    """The sampled answers' values as arrays, key by key."""
    keys = sorted({k for _, vals in picked for k in vals})
    return {k: np.array([vals.get(k, math.nan) for _, vals in picked], dtype=np.float64) for k in keys}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every gap within its limit, {family: {"value", "limit"}})."""
    checks = {fam: {"value": v, "limit": float(limits[fam])} for fam, v in found.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
