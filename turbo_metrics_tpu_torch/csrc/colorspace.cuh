// YUV -> clamped linear RGB, shared by every kernel that converts decoded
// planes (ssimulacra2_scale.cu's scale-0 pass and convert.cu's conversions),
// so that all of them compute bit-identical RGB.
//
// Conventions (the port's ops/colorspace.py, after the reference's
// cuda-colorspace-kernel): luma is clamped below at the range minimum and not
// above before the transfer function; chroma is upsampled nearest-neighbour,
// one (Cb, Cr) pair per 2x2 luma quad; linear RGB is clamped to [0, 1].
//
// The transfer function is a template parameter of the kernels that include
// this header: each instance carries one EOTF and no per-channel switch
// (dispatch_transfer picks the instance on the host).  Against the plain
// twin's arithmetic (ops/colorspace.py) two cuts move bits, each by a few
// ulp of f32: divisions by constants are multiplications by the constants'
// f32 reciprocals, and x^e on its domain (finite x >= 0, e > 0) is
// 2^(e log2 x) by the special-function unit's approximate lg2 and ex2 (two
// MUFU instructions) instead of powf (some sixty instructions).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum Transfer { kBt709 = 0, kSrgb = 1, kPq = 2, kHlg = 3, kLinear = 4 };

struct ConvParams {
  float y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2;
  float minimum, neutral;
};

// x^e for finite x >= 0 and e > 0 (x = 0: lg2 gives -inf, ex2 then 0).
__device__ __forceinline__ float pow_pos(float x, float e) {
  float l, p;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(e * l));
  return p;
}

// Transfer functions to linear light, in the pow form of the JAX package's
// ops/colorspace.py (f32 constants rounded from the same f64 expressions).
template <int TF>
__device__ __forceinline__ float eotf(float v) {
  if constexpr (TF == kBt709) {
    constexpr float alpha = (float)(1.0 + 5.5 * 0.018053968510807);
    constexpr float threshold = (float)0.08124285829863521;
    const float lo = v * (1.0f / 4.5f);
    const float hi = pow_pos(fmaxf((v + (alpha - 1.0f)) * (1.0f / alpha), 0.0f), (float)(1.0 / 0.45));
    return v >= threshold ? hi : lo;
  } else if constexpr (TF == kSrgb) {
    constexpr float alpha = 1.0550107f;
    constexpr float beta = 0.0030412825f;
    const float lo = v * (1.0f / 12.92f);
    const float hi = pow_pos(fmaxf((v + (alpha - 1.0f)) * (1.0f / alpha), 0.0f), 2.4f);
    return v < 12.92f * beta ? lo : hi;
  } else if constexpr (TF == kPq) {
    constexpr float m1 = (float)(2610.0 / 16384.0);
    constexpr float m2 = (float)(2523.0 / 4096.0 * 128.0);
    constexpr float c1 = (float)(3424.0 / 4096.0);
    constexpr float c2 = (float)(2413.0 / 4096.0 * 32.0);
    constexpr float c3 = (float)(2392.0 / 4096.0 * 32.0);
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    const float p = pow_pos(v, 1.0f / m2);
    const float num = fmaxf(p - c1, 0.0f);
    const float den = fmaxf(c2 - c3 * p, 1e-6f);
    return pow_pos(num / den, 1.0f / m1);
  } else if constexpr (TF == kHlg) {
    constexpr float a = 0.17883277f;
    constexpr float b = (float)(1.0 - 4.0 * 0.17883277);
    constexpr float c = (float)0.559910729529562;  // 0.5 - a * ln(4a)
    return v <= 0.5f ? (v * v) * (1.0f / 3.0f) : (expf((v - c) * (1.0f / a)) + b) * (1.0f / 12.0f);
  } else {
    return v;
  }
}

// Calls f(std::integral_constant<int, TF>{}) for the transfer code; false
// (f not called) for an unknown code.
template <typename F>
bool dispatch_transfer(int transfer, F&& f) {
  switch (transfer) {
    case kBt709: f(std::integral_constant<int, kBt709>{}); return true;
    case kSrgb: f(std::integral_constant<int, kSrgb>{}); return true;
    case kPq: f(std::integral_constant<int, kPq>{}); return true;
    case kHlg: f(std::integral_constant<int, kHlg>{}); return true;
    case kLinear: f(std::integral_constant<int, kLinear>{}); return true;
    default: return false;
  }
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// The chroma terms one (Cb, Cr) pair adds to the luma of its quad's pixels.
struct ChromaTerms {
  float r, g, b;
};

__device__ __forceinline__ ChromaTerms chroma_terms(float cb_code, float cr_code,
                                                    const ConvParams& p) {
  const float cb = cb_code - p.neutral;
  const float cr = cr_code - p.neutral;
  return {p.r_coeff * cr, p.g_coeff1 * cb + p.g_coeff2 * cr, p.b_coeff * cb};
}

// One pixel: luma code value + its quad's chroma terms -> clamped linear RGB.
template <int TF>
__device__ __forceinline__ void pixel_rgb(float y_code, const ChromaTerms& t, const ConvParams& p,
                                          float rgb[3]) {
  const float l = (fmaxf(y_code, p.minimum) - p.minimum) * p.y_coeff;
  rgb[0] = clamp01(eotf<TF>(l + t.r));
  rgb[1] = clamp01(eotf<TF>(l + t.g));
  rgb[2] = clamp01(eotf<TF>(l + t.b));
}

}  // namespace
