// YUV -> clamped linear RGB, shared by every kernel that converts decoded
// planes (ssimulacra2_scale.cu's scale-0 pass and convert.cu's pair
// conversion), so that all of them compute bit-identical RGB.
//
// Conventions (the port's ops/colorspace.py, after the reference's
// cuda-colorspace-kernel): luma is clamped below at the range minimum and not
// above before the transfer function; chroma is upsampled nearest-neighbour,
// one (Cb, Cr) pair per 2x2 luma quad; linear RGB is clamped to [0, 1].
#pragma once

#include <cuda_runtime.h>

namespace {

enum Transfer { kBt709 = 0, kSrgb = 1, kPq = 2, kHlg = 3, kLinear = 4 };

struct ConvParams {
  float y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2;
  float minimum, neutral;
  int transfer;
};

// Transfer functions to linear light, in the pow form of the JAX package's
// ops/colorspace.py (f32 constants rounded from the same f64 expressions).
__device__ __forceinline__ float eotf(float v, int transfer) {
  switch (transfer) {
    case kBt709: {
      const float alpha = (float)(1.0 + 5.5 * 0.018053968510807);
      const float threshold = (float)0.08124285829863521;
      const float lo = v / 4.5f;
      const float hi = powf(fmaxf((v + (alpha - 1.0f)) / alpha, 0.0f), (float)(1.0 / 0.45));
      return v >= threshold ? hi : lo;
    }
    case kSrgb: {
      const float alpha = 1.0550107f;
      const float beta = 0.0030412825f;
      const float lo = v / 12.92f;
      const float hi = powf(fmaxf((v + (alpha - 1.0f)) / alpha, 0.0f), 2.4f);
      return v < 12.92f * beta ? lo : hi;
    }
    case kPq: {
      const float m1 = (float)(2610.0 / 16384.0);
      const float m2 = (float)(2523.0 / 4096.0 * 128.0);
      const float c1 = (float)(3424.0 / 4096.0);
      const float c2 = (float)(2413.0 / 4096.0 * 32.0);
      const float c3 = (float)(2392.0 / 4096.0 * 32.0);
      v = fminf(fmaxf(v, 0.0f), 1.0f);
      const float p = powf(v, 1.0f / m2);
      const float num = fmaxf(p - c1, 0.0f);
      const float den = fmaxf(c2 - c3 * p, 1e-6f);
      return powf(num / den, 1.0f / m1);
    }
    case kHlg: {
      const float a = 0.17883277f;
      const float b = (float)(1.0 - 4.0 * 0.17883277);
      const float c = (float)0.559910729529562;  // 0.5 - a * ln(4a)
      return v <= 0.5f ? (v * v) / 3.0f : (expf((v - c) / a) + b) / 12.0f;
    }
    default:
      return v;
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
__device__ __forceinline__ void pixel_rgb(float y_code, const ChromaTerms& t, const ConvParams& p,
                                          float rgb[3]) {
  const float l = (fmaxf(y_code, p.minimum) - p.minimum) * p.y_coeff;
  rgb[0] = clamp01(eotf(l + t.r, p.transfer));
  rgb[1] = clamp01(eotf(l + t.g, p.transfer));
  rgb[2] = clamp01(eotf(l + t.b, p.transfer));
}

}  // namespace
