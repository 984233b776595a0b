"""tail_roofline_pct: the least time of SSIMULACRA2's levels 3-5 of the
window's batches (the work kernel #4, ``fused_tail_kernel``, takes at
3840x2160) over that kernel's device time in the trace, in percent; None
where it never ran.

The work is counted as roofline.py counts SSIMULACRA2 (its per-pixel
constants, per scale of ``scale_dims``, the maps that nonzero ``WEIGHTS``
need), from level 3's linear-RGB pair: the 2x2 means that make levels 4
and 5, not the one that made level 3 (kernel #3 emits it).  Bytes: level
3's pair read once and the three levels' (3, 6) f32 sums written.
"""

from portbench import roofline
from portbench.metrics import tail_ms
from portbench.reference.ssimulacra2 import WEIGHTS, scale_dims

# The frame of the cells this metric lists (configs/all6_2160p10.json), and
# the first level kernel #4 takes there (models/ssimulacra2.py level_route).
FRAME = (2160, 3840)
FIRST_LEVEL = 3


def tail_ops(h: int, w: int, first: int = FIRST_LEVEL) -> float:
    """f32 operations of one frame pair's SSIMULACRA2 levels ``first``..
    from level ``first``'s linear RGB (first 0: ``roofline.ssimulacra2_ops``)."""
    dims = scale_dims(h, w)
    wts = WEIGHTS[:3 * len(dims) * 6].reshape(3, len(dims), 2, 3) != 0
    ops = 0.0
    for s in range(first, len(dims)):
        sh, sw = dims[s]
        per = roofline.S2_XYB + (roofline.S2_HALF if s > first else 0)
        for c in range(3):
            ssim, art, det = (bool(wts[c, s, :, m].any()) for m in range(3))
            if ssim:
                per += roofline.S2_SSIM
            elif art or det:
                per += roofline.S2_EDGE_BLURS
            if art or det:
                per += roofline.S2_EDGE + roofline.S2_EDGE_MAP * (art + det)
        ops += per * sh * sw
    return ops


def tail_work(h: int, w: int, batch: int, first: int = FIRST_LEVEL) -> roofline.Work:
    """The least work of one batch's levels ``first``.. of an h x w frame."""
    dims = scale_dims(h, w)
    lh, lw = dims[first]
    nbytes = 2 * 3 * lh * lw * 4 + (len(dims) - first) * 3 * 6 * 4
    return roofline.Work(0.0, batch * tail_ops(h, w, first), batch * nbytes)


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    seconds = tail_ms.tail_seconds(run.trace)
    if seconds <= 0:
        return None
    batch = run.frames // len(run.latencies_s)
    batches = len(run.trace.spans["pb.batch"])
    return 100.0 * batches * tail_work(*FRAME, batch).least_seconds() / seconds
