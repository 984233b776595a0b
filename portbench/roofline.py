"""The least time a batch's metric work can take on one H100.

Operations and bytes are counted from each metric's definition at the
cell's shapes, not from the program's kernel passes: the least arithmetic
the definition needs, symmetric filter taps folded (an N-tap symmetric
filter: (N - 1) / 2 adds of tap pairs, one multiply and (N - 1) / 2
multiply-adds per output), sub-scores whose SSIMULACRA2 weight is zero not
computed, and work shared by two families (the conversion to linear RGB,
the 8-bit quantization, SSIM's statistics inside MS-SSIM's first scale)
counted once.  A multiply-add counts as two operations, a comparison, a
select, a power's log2 and exp2 or a rounding as one each.  Bytes: each
input plane of the batch read once (and the stream state that a temporal
metric reads and writes), each output written once.

The least time of a batch is max(int32 operations / int32 peak, all
operations / f32 peak, bytes / memory bandwidth): int32 and f32 work share
the SMs' issue slots, int32 at half the f32 rate.  Peaks: NVIDIA's H100
SXM data sheet at the 700 W limit, 67 TFLOP/s f32 outside the tensor
cores, 33.5 TOP/s int32 (64 of each SM's 128 lanes), 3.35 TB/s.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.reference.ssimulacra2 import WEIGHTS, scale_dims

PEAK_F32 = 67e12
PEAK_I32 = 33.5e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Work:
    int_ops: float = 0.0
    f32_ops: float = 0.0
    bytes: float = 0.0

    def least_seconds(self) -> float:
        return max(self.int_ops / PEAK_I32, (self.int_ops + self.f32_ops) / PEAK_F32, self.bytes / PEAK_BYTES)


def sym(n: int) -> float:
    """Operations per output of an n-tap symmetric filter, taps folded."""
    return 3 * (n - 1) / 2 + 1


# -- per-pixel counts ---------------------------------------------------------

# One image to linear RGB, per pixel: the luma's offset, scale and clamp 3;
# per channel the chroma term 1, the transfer's argument (a multiply-add) 2,
# its power (log2, multiply, exp2) 3, its segment select 2 and the final
# clamp 2.  Per chroma sample: both offsets 2 and the four matrix terms 5.
CONVERT_PIXEL = 3 + 3 * 10
CONVERT_CHROMA = 7
# sRGB to linear, per pixel: per channel the scale 1 and the transfer 9.
SRGB_PIXEL = 3 * 10
# SSIMULACRA2, per pixel of a scale: the 2x2 mean of both images (4 per
# channel and image) at scales past the first; XYB of both images (opsin
# mix 18, three cube roots 9, the bias root 3, X and Y 4, the shift 5);
# the blur 15 per output and pass (the recursive Gaussian's recurrence, the
# least of its forms); per channel with the SSIM map: the products 4, four
# planes blurred, the map 15 and its norms 4; with the edge maps only: two
# planes blurred; the edge ratio 7 and per map its clamp and norms 5.
S2_HALF = 24
S2_XYB = 2 * 39
S2_BLUR = 15
S2_SSIM = 4 + 4 * 2 * S2_BLUR + 15 + 4
S2_EDGE_BLURS = 2 * 2 * S2_BLUR
S2_EDGE = 7
S2_EDGE_MAP = 5
# 8-bit quantization of both images, per sample: x * 255, round, two clamps.
QUANT_SAMPLE = 8
# PSNR per sample: the difference and its square added.
PSNR_SAMPLE = 3
# SSIM per sample of a scale: the products 4, four planes through the
# 11-tap window's row pass (over the valid columns) and column pass (over
# the valid grid); per valid sample the map 17 (luminance 8, contrast-
# structure 6, product 1, sums 2), or 9 where only the contrast-structure
# mean is needed; the 2x2 mean of both images 8 per sample of the next.
SSIM_PRODUCTS = 4
SSIM_PLANES = 4
SSIM_MAP = 17
CS_MAP = 9
SSIM_HALF = 8
# XPSNR, int32 per pixel: the highpass (separable [1 2 1] passes 6, the
# centre 2, abs 1, its block sum 1), the squared error 3, the temporal
# activity 3.
XPSNR_PIXEL = 16
# Motion, int32 per pixel: two 5-tap passes (folded 7, rounding 2) and the
# SAD 3.
MOTION_PIXEL = 2 * (sym(5) + 2) + 3
# VIF per pixel of a scale: the products 3, five planes through both passes
# of the scale's window, the guarded map with its two log2 and sums 32, and
# below the last scale the next one: both images through the window at the
# decimated positions (the row pass at half the columns, the column pass at
# a quarter of the pixels).
VIF_MAP = 3 + 32
# ADM per input pixel of a level: the db2 row pass (lo and hi, both images,
# half the columns) 14, the column pass (four bands, both images, a quarter
# of the pixels) 14; per band pixel the angle gate 14, decoupling and CSF of
# three bands 27, the 3x3 mask 13, the masked bands 9, and the cubes of the
# centre region 21 (0.64 of the band).
ADM_PIXEL = 14 + 14 + (14 + 27 + 13 + 9 + 21 * 0.64) / 4


def _plane_bytes(fmt: dict, h: int, w: int) -> float:
    size = 1 if fmt["depth"] == 8 else 2
    if fmt["kind"] == "rgb":
        return 3.0 * h * w * size
    sub = {420: 4, 422: 2, 444: 1}[fmt["chroma"]]
    return (h * w + 2.0 * h * w / sub) * size


def _convert(fmt: dict, h: int, w: int) -> float:
    if fmt["kind"] == "rgb":
        return SRGB_PIXEL * h * w
    sub = {420: 4, 422: 2, 444: 1}[fmt["chroma"]]
    return CONVERT_PIXEL * h * w + CONVERT_CHROMA * h * w / sub


def ssimulacra2_ops(h: int, w: int) -> float:
    """f32 operations of one frame pair's SSIMULACRA2 from linear RGB."""
    dims = scale_dims(h, w)
    wts = WEIGHTS[:3 * len(dims) * 6].reshape(3, len(dims), 2, 3) != 0
    ops = 0.0
    for s, (sh, sw) in enumerate(dims):
        px = sh * sw
        per = S2_XYB + (S2_HALF if s else 0)
        for c in range(3):
            ssim, art, det = (bool(wts[c, s, :, m].any()) for m in range(3))
            if ssim:
                per += S2_SSIM
            elif art or det:
                per += S2_EDGE_BLURS
            if art or det:
                per += S2_EDGE + S2_EDGE_MAP * (art + det)
        ops += per * px
    return ops


def msssim_levels(h: int, w: int) -> int:
    return min(5, max(1, (min(h, w) // 11).bit_length()))


def ssim_family_ops(h: int, w: int, levels: int) -> float:
    """f32 operations of one pair's SSIM statistics over ``levels`` scales
    of 8-bit codes (levels 1: SSIM alone)."""
    ops = 0.0
    for lv in range(levels):
        vh, vw = max(h - 10, 0), max(w - 10, 0)
        per_channel = (SSIM_PRODUCTS * h * w + SSIM_PLANES * sym(11) * (h * vw + vh * vw)
                       + (SSIM_MAP if lv == levels - 1 or lv == 0 else CS_MAP) * vh * vw)
        if lv:
            per_channel += SSIM_HALF * h * w
        ops += 3 * per_channel
        h, w = h // 2, w // 2
    return ops


def vif_ops(h: int, w: int) -> float:
    ops = 0.0
    for k in range(4):
        n = (1 << (4 - k)) + 1
        px = h * w
        ops += px * (VIF_MAP + 5 * 2 * sym(n))
        if k < 3:
            nxt = (1 << (3 - k)) + 1
            ops += px * 2 * 0.75 * sym(nxt)
        h, w = (h + 1) // 2, (w + 1) // 2
    return ops


def adm_ops(h: int, w: int) -> float:
    ops = 0.0
    for _ in range(4):
        ops += ADM_PIXEL * h * w
        h, w = (h + 1) // 2, (w + 1) // 2
    return ops


def batch_work(metrics, fmt_ref: dict, fmt_dis: dict, h: int, w: int, batch: int) -> Work:
    """The least work of one batch of ``batch`` frame pairs."""
    m = set(metrics)
    rgb = m & {"ssimulacra2", "psnr", "ssim", "msssim"}
    f32 = 0.0
    i32 = 0.0
    state = 0.0
    if rgb:
        f32 += _convert(fmt_ref, h, w) + _convert(fmt_dis, h, w)
    if "ssimulacra2" in m:
        f32 += ssimulacra2_ops(h, w)
    if m & {"psnr", "ssim", "msssim"}:
        f32 += QUANT_SAMPLE * 3 * h * w
    if "psnr" in m:
        f32 += PSNR_SAMPLE * 3 * h * w
    if "msssim" in m:
        f32 += ssim_family_ops(h, w, msssim_levels(h, w))
    elif "ssim" in m:
        f32 += ssim_family_ops(h, w, 1)
    luma = 1 if fmt_ref["depth"] == 8 else 2
    if "xpsnr" in m:
        i32 += XPSNR_PIXEL * h * w
        state += 2 * h * w * luma  # the previous reference luma, read and kept
    if "vmaf" in m:
        i32 += MOTION_PIXEL * h * w
        state += 2 * h * w * 2  # the previous blurred plane (16-bit), read and kept
        if fmt_ref["depth"] != 8 or fmt_dis["depth"] != fmt_ref["depth"]:
            f32 += 2 * h * w  # the luma pair to 8-bit units
        f32 += vif_ops(h, w) + adm_ops(h, w)
    inputs = _plane_bytes(fmt_ref, h, w) + _plane_bytes(fmt_dis, h, w)
    return Work(i32 * batch, f32 * batch, inputs * batch + state)

