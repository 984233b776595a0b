"""Colorspace conversion: planar YUV or gamma sRGB -> linear RGB, in plain torch.

The plain counterpart of the conversions of the CUDA kernels
(ops/kernels/scale_stats.py, ops/kernels/convert.py).  Conventions carried over from the
reference (cuda-colorspace-kernel/src/{lib.rs,biplanar.rs}):
  * YCbCr -> R'G'B' coefficients are derived from the colour primaries
    (kr/kb via the XYZ route, lib.rs:203-218), not the rounded constants.
  * Luma is clamped below at the range minimum but not above before the
    transfer function (biplanar.rs:47-53); linear RGB is clamped to [0, 1].
  * Chroma upsampling is nearest-neighbour: one chroma pair per 2x2 luma
    block (biplanar.rs:31-44).
  * The BT.709 "EOTF" is the inverse OETF (power 1/0.45 with a linear toe),
    in its pow form (lib.rs:221-235).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import routes


def _xy_to_xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y], dtype=np.float64)


def luma_coefficients(r, g, b, w) -> tuple[float, float]:
    """(kr, kb) derived from chromaticity primaries (f64)."""
    r_xyz, g_xyz, b_xyz, w_xyz = (_xy_to_xyz(*p) for p in (r, g, b, w))
    x_rgb = np.array([r_xyz[0], g_xyz[0], b_xyz[0]])
    y_rgb = np.array([r_xyz[1], g_xyz[1], b_xyz[1]])
    z_rgb = np.array([r_xyz[2], g_xyz[2], b_xyz[2]])
    mul = 1.0 / np.dot(x_rgb, np.cross(y_rgb, z_rgb))
    kr = np.dot(w_xyz, np.cross(g_xyz, b_xyz)) * mul
    kb = np.dot(w_xyz, np.cross(r_xyz, g_xyz)) * mul
    return float(kr), float(kb)


_D65 = (0.3127, 0.3290)
PRIMARIES = {
    "bt709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
    "bt601_525": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070), _D65),
    "bt601_625": ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060), _D65),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _D65),
}

MATRIX_KR_KB = {name: luma_coefficients(*prims) for name, prims in PRIMARIES.items()}


# --------------------------------------------------------------------------
# Transfer functions (to linear), f32 throughout
# --------------------------------------------------------------------------

def _f32(v: float) -> float:
    """A constant rounded to f32, as the reference's float literals are."""
    return float(np.float32(v))


def bt709_eotf(v: torch.Tensor) -> torch.Tensor:
    """Inverse of the BT.709 OETF (cuda-colorspace-kernel/src/lib.rs:221-235)."""
    alpha = _f32(1.0 + 5.5 * 0.018053968510807)
    threshold = _f32(0.08124285829863521)
    lo = v / _f32(4.5)
    hi = torch.pow(
        torch.clamp_min((v + _f32(alpha - 1.0)) / alpha, 0.0), _f32(1.0 / 0.45)
    )
    return torch.where(v >= threshold, hi, lo)


def srgb_eotf(v: torch.Tensor) -> torch.Tensor:
    """sRGB inverse OETF (cuda-colorspace-kernel/src/srgb.rs:40-48)."""
    alpha = _f32(1.0550107)
    beta = _f32(0.0030412825)
    lo = v / _f32(12.92)
    hi = torch.pow(torch.clamp_min((v + _f32(alpha - 1.0)) / alpha, 0.0), _f32(2.4))
    return torch.where(v < _f32(_f32(12.92) * beta), lo, hi)


def pq_eotf(v: torch.Tensor, *, peak_nits: float = 10000.0, norm_nits: float = 10000.0) -> torch.Tensor:
    """SMPTE ST 2084 (PQ) EOTF, normalised so ``norm_nits`` -> 1.0 (the
    curve's peak is ``peak_nits``).  The conversions (``TRANSFERS`` and
    kernels #5, #6 and kernel 1) take the defaults, 10000 and 10000."""
    m1 = _f32(2610.0 / 16384.0)
    m2 = _f32(2523.0 / 4096.0 * 128.0)
    c1 = _f32(3424.0 / 4096.0)
    c2 = _f32(2413.0 / 4096.0 * 32.0)
    c3 = _f32(2392.0 / 4096.0 * 32.0)
    # PQ is defined on [0, 1] code values; limited-range overshoot would
    # drive the denominator negative.
    v = torch.clamp(v, 0.0, 1.0)
    p = torch.pow(v, _f32(1.0 / m2))
    num = torch.clamp_min(p - c1, 0.0)
    den = torch.clamp_min(c2 - c3 * p, _f32(1e-6))
    return torch.pow(num / den, _f32(1.0 / m1)) * _f32(peak_nits / norm_nits)


def hlg_eotf(v: torch.Tensor) -> torch.Tensor:
    """HLG inverse OETF (scene-linear, normalised to [0, 1])."""
    a = _f32(0.17883277)
    b = _f32(1.0 - 4.0 * 0.17883277)
    c = _f32(0.5 - 0.17883277 * np.log(4.0 * 0.17883277))
    lo = (v * v) / 3.0
    hi = (torch.exp((v - c) / a) + b) / 12.0
    return torch.where(v <= 0.5, lo, hi)


def identity_eotf(v: torch.Tensor) -> torch.Tensor:
    return v


TRANSFERS = {
    "bt709": bt709_eotf,
    "srgb": srgb_eotf,
    "pq": pq_eotf,
    "hlg": hlg_eotf,
    "linear": identity_eotf,
}


# --------------------------------------------------------------------------
# Range handling
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SampleRange:
    """Code-value geometry for a bit depth and signal range
    (ColorRange in cuda-colorspace-kernel/src/lib.rs:42-169)."""

    minimum: int
    luma_max: int
    chroma_max: int
    neutral: int

    @property
    def luma_range(self) -> int:
        return self.luma_max - self.minimum

    @property
    def chroma_range(self) -> int:
        return self.chroma_max - self.minimum


def sample_range(depth: int, full_range: bool) -> SampleRange:
    if full_range:
        return SampleRange(0, (1 << depth) - 1, (1 << depth) - 1, 1 << (depth - 1))
    shift = depth - 8
    return SampleRange(16 << shift, 235 << shift, 240 << shift, 1 << (depth - 1))


def conversion_coeffs(
    depth: int, matrix: str, full_range: bool, kr_kb=None
) -> tuple[float, float, float, float, float]:
    """f32-rounded (y, r, b, g1, g2) coefficients of the YCbCr -> R'G'B'
    matrix for a code-value geometry; ``kr_kb`` overrides the built-in
    ``MATRIX_KR_KB[matrix]`` pair."""
    kr, kb = MATRIX_KR_KB[matrix] if kr_kb is None else (float(kr_kb[0]), float(kr_kb[1]))
    rng = sample_range(depth, full_range)
    kg = 1.0 - kr - kb
    return (
        _f32(1.0 / rng.luma_range),
        _f32(2.0 * (1.0 - kr) / rng.chroma_range),
        _f32(2.0 * (1.0 - kb) / rng.chroma_range),
        _f32(-2.0 * (1.0 - kb) * kb / kg / rng.chroma_range),
        _f32(-2.0 * (1.0 - kr) * kr / kg / rng.chroma_range),
    )


# --------------------------------------------------------------------------
# Conversion
# --------------------------------------------------------------------------

def chroma_dims(chroma: int, h: int, w: int) -> tuple[int, int]:
    """(ch, cw) of the chroma grid of an h x w image at a subsampling."""
    if chroma == 444:
        return h, w
    if chroma == 422:
        return h, (w + 1) // 2
    if chroma == 420:
        return (h + 1) // 2, (w + 1) // 2
    raise ValueError(f"chroma must be 420, 422 or 444, got {chroma!r}")


def _kernel_ok(y, uv, depth: int, transfer: str, chroma: int, backend) -> bool:
    """Whether ``yuv420_to_linear_rgb`` takes kernel #5 (its docstring)."""
    if not routes.kernel_route(backend, y.device) or y.ndim != 3 or transfer not in TRANSFERS:
        return False
    want_dt = torch.uint8 if depth == 8 else torch.uint16
    return (8 <= depth <= 16 and y.dtype == uv.dtype == want_dt
            and tuple(uv.shape) == (y.shape[0], *chroma_dims(chroma, *y.shape[-2:]), 2))


def yuv420_to_linear_rgb(
    y: torch.Tensor,
    uv: torch.Tensor,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    kr_kb=None,
    chroma: int = 420,
    backend: str | None = "auto",
) -> torch.Tensor:
    """Planar YCbCr -> linear RGB f32 in [0, 1].

    ``y``: (..., H, W) integer luma; ``uv``: (..., ch, cw, 2) chroma (Cb,
    Cr) at the ``chroma`` subsampling's grid: 420 (ceil(H/2), ceil(W/2)),
    422 (H, ceil(W/2)), 444 (H, W).  Output: (..., 3, H, W) f32.  The
    reference decimates every input to NVDEC's 4:2:0 surfaces; 4:2:2 and
    4:4:4 keep their real chroma grid here, as in the JAX package.

    ``backend`` (ops/routes.py; JAX's default "auto"): on the kernel route,
    batched (B, H, W) luma with chroma on its grid, both uint8 at 8 bits or
    uint16 at 9-16, go to kernel #5 (ops/kernels/convert.py
    ``yuv_to_linear_rgb``), ``kr_kb`` and ``chroma`` passed through.  JAX's
    gate also asks for 4:2:0, the one layout of its Pallas kernel; #5
    converts 4:2:2 and 4:4:4 as well, so this route takes all three.  Any
    other input runs the plain version below, as does "jnp".
    """
    if _kernel_ok(y, uv, depth, transfer, chroma, backend):
        from turbo_metrics_tpu_torch.ops.kernels import convert

        return convert.yuv_to_linear_rgb(
            y.contiguous(), uv.contiguous(), depth=depth, matrix=matrix, transfer=transfer, full_range=full_range,
            chroma=chroma, kr_kb=kr_kb,
        )
    y_c, r_c, b_c, g1_c, g2_c = conversion_coeffs(depth, matrix, full_range, kr_kb)
    rng = sample_range(depth, full_range)
    h, w = y.shape[-2], y.shape[-1]
    luma = (
        torch.clamp_min(y.to(torch.float32), float(rng.minimum)) - float(rng.minimum)
    ) * y_c
    cb = uv[..., 0].to(torch.float32) - float(rng.neutral)
    cr = uv[..., 1].to(torch.float32) - float(rng.neutral)
    chans = (r_c * cr, g1_c * cb + g2_c * cr, b_c * cb)

    def up(c):
        # Nearest neighbour onto the luma grid: 420 one pair per 2x2 luma
        # block, 422 per 1x2 block, 444 already co-sited.
        if chroma != 444:
            c = c.repeat_interleave(2, dim=-1)
        if chroma == 420:
            c = c.repeat_interleave(2, dim=-2)
        return c[..., :h, :w]

    rgb = torch.stack([luma + up(c) for c in chans], dim=-3)
    return torch.clamp(TRANSFERS[transfer](rgb), 0.0, 1.0)


def srgb_to_linear(x: torch.Tensor, *, depth: int | None = None) -> torch.Tensor:
    """Gamma sRGB -> linear f32.

    Integer inputs are normalised by (2^depth - 1) first (depth from the
    dtype when not given).  Matches srgb_to_linear_{u8,u16,f32}
    (cuda-colorspace-kernel/src/srgb.rs:50-127); the reference's u8 LUT is
    the formula tabulated, so the formula is used directly.
    """
    if not x.is_floating_point():
        if depth is None:
            depth = 8 if x.dtype == torch.uint8 else 16
        x = x.to(torch.float32) / _f32((1 << depth) - 1)
    return srgb_eotf(x)


def packed_rgb_to_linear(
    x: torch.Tensor, out: torch.Tensor, *, depth: int | None = None, transfer: str = "srgb"
) -> torch.Tensor:
    """(B, h, w, 3) packed-RGB samples -> linear f32 in ``out`` (B, 3, h, w),
    which is returned: "linear" takes the samples as they are, any other
    ``transfer`` is ``srgb_to_linear`` at ``depth``."""
    rgb = x.permute(0, 3, 1, 2)
    out.copy_(rgb.to(torch.float32) if transfer == "linear" else srgb_to_linear(rgb, depth=depth))
    return out


def srgb_pair_to_linear(ref: torch.Tensor, dis: torch.Tensor, *, depth: int | None = None) -> torch.Tensor:
    """Two inputs' (B, h, w, 3) sRGB samples -> the (2, B, 3, h, w) f32
    linear-RGB pair buffer of the multi-metric route, reference in slot 0."""
    bsz, h, w, _ = ref.shape
    p12 = torch.empty((2, bsz, 3, h, w), dtype=torch.float32, device=ref.device)
    for slot, x in enumerate((ref, dis)):
        packed_rgb_to_linear(x, p12[slot], depth=depth)
    return p12


def f32_to_uint8(x: torch.Tensor, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Quantize [0, 1] f32 to 8-bit code values, clip(round(x * 255), 0, 255).

    The reference's f32_to_8bit (cuda-colorspace-kernel/src/sample_conv.rs:
    5-35) with round half to even, as ``jnp.round`` and ``torch.round`` do.
    ``dtype=torch.float32`` keeps the code values in f32, where PSNR and the
    SSIM family compute on them.
    """
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(dtype)
