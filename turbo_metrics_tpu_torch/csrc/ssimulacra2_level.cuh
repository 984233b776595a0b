// The per-pixel arithmetic of one SSIMULACRA2 pyramid level, shared by the
// per-level launches of ssimulacra2_scale.cu (kernels 1, 2, #3, #8, #10) and
// the persistent tail kernel of ssimulacra2_tail.cu (#4), so that every
// route computes the same values in the same order:
//   * cbrt_nr / to_xyb: linear RGB -> positive-shifted XYB (ops/xyb.py);
//   * rgb_quad: one 2x2 quad of a linear-RGB level -> XYB of its pixels and
//     the quad's mean, the next level's pixel;
//   * row_tap: one tap of the horizontal 11-tap pass of x1, x2, (x1-x2)^2,
//     x1*x2;
//   * col_tap: one tap of the vertical pass of those four row sums;
//   * ssim_maps: the SSIM, artifact and detail-loss maps of one pixel from
//     its four blurred quantities, and the six reduced quantities.
// The callers differ only in where the taps' samples come from (device
// memory in #4, a shared-memory tile in the fused level kernel) and in how
// they skip the taps outside the plane: #4 skips them, the fused kernel adds
// zero-filled samples.  A zero sample adds t * 0 = +0 to a sum that is never
// -0, so both give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

// Newton-refined cube root of max(v, 0) (ops/xyb.py _cbrt).
__device__ __forceinline__ float cbrt_nr(float v) {
  v = fmaxf(v, 0.0f);
  const float y0 = cbrtf(v);
  const float refined = (2.0f * y0 + v / fmaxf(y0 * y0, 1e-30f)) * (float)(1.0 / 3.0);
  return v > 0.0f ? refined : 0.0f;
}

// o: 9 opsin matrix entries (row-major), bias, bias root.
__device__ __forceinline__ void to_xyb(float r, float g, float b, const float* o,
                                       float* x_out, float* y_out, float* b_out) {
  const float rmix = o[0] * r + o[1] * g + o[2] * b + o[9];
  const float gmix = o[3] * r + o[4] * g + o[5] * b + o[9];
  const float bmix = o[6] * r + o[7] * g + o[8] * b + o[9];
  const float rg = cbrt_nr(rmix) - o[10];
  const float gr = cbrt_nr(gmix) - o[10];
  const float bb = cbrt_nr(bmix) - o[10];
  const float x = 0.5f * (rg - gr);
  const float y = 0.5f * (rg + gr);
  *x_out = x * 14.0f + 0.42f;
  *y_out = y + 0.01f;
  *b_out = bb - y + 0.55f;
}

// Quad (qi, qj) of one image's h x w linear-RGB level src (3 planes of npx):
// the XYB of the quad's pixels that lie inside the image into xp (3 planes of
// npx), and unless next is null the quad's mean into next[ch * nq] (the
// pixel's address in the next level's first plane).  A quad that hangs over
// an odd edge replicates the last row/column, summed ((a+b)+c)+d as
// ops/downscale.py does.
__device__ __forceinline__ void rgb_quad(const float* __restrict__ src, int h, int w, int qi,
                                         int qj, const float* o, float* __restrict__ xp,
                                         float* __restrict__ next, size_t nq) {
  const size_t npx = (size_t)h * w;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int r = min(2 * qi + dy, h - 1);
      const int c = min(2 * qj + dx, w - 1);
      const size_t at = (size_t)r * w + c;
      const float v[3] = {src[at], src[npx + at], src[2 * npx + at]};
      acc[0] += v[0];
      acc[1] += v[1];
      acc[2] += v[2];
      if (2 * qi + dy < h && 2 * qj + dx < w) {
        to_xyb(v[0], v[1], v[2], o, xp + at, xp + npx + at, xp + 2 * npx + at);
      }
    }
  }
  if (next != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) next[ch * nq] = acc[ch] * 0.25f;
  }
}

// One tap t of the horizontal pass on the reference's sample av and the
// distorted image's bv: s accumulates blurred x1, x2, (x1-x2)^2, x1*x2.  The
// SSIM map needs s11 and s22 only through s11 + s22 - 2 s12 =
// blur((x1-x2)^2), so four blurred planes suffice (ops/ssim_maps.py
// ssim_map).  Callers run k = 0..10 in order from s = 0.
__device__ __forceinline__ void row_tap(float (&s)[4], float t, float av, float bv) {
  s[0] += t * av;
  s[1] += t * bv;
  const float dv = av - bv;
  s[2] += t * (dv * dv);
  s[3] += t * (av * bv);
}

// One tap t of the vertical pass on the four row sums x of one row.
__device__ __forceinline__ void col_tap(float (&s)[4], float t, const float (&x)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] += t * x[q];
}

// The maps of one pixel from its blurred quantities s (mu1, mu2, blurred
// (x1-x2)^2, blurred x1*x2) and its XYB samples i1 (reference) and i2
// (distorted).  v: d, d^4, art, art^4, det, det^4.
__device__ __forceinline__ void ssim_maps(const float (&s)[4], float i1, float i2,
                                          float (&v)[6]) {
  const float mu1 = s[0], mu2 = s[1], sdd = s[2], s12 = s[3];

  // 1 - (1 - md^2) num_s / denom_s with denom_s = num_s + var_d, written
  // from the variance of x1 - x2 (well conditioned for close images).
  const float c2 = 0.0009f;
  const float md = mu1 - mu2;
  const float num_s = 2.0f * (s12 - mu1 * mu2) + c2;
  const float var_d = sdd - md * md;
  const float d = fmaxf((var_d + md * md * num_s) / (num_s + var_d), 0.0f);

  const float ea = fabsf(i2 - mu2);
  const float eb = fabsf(i1 - mu1);
  const float d1 = (ea - eb) / (1.0f + eb);
  const float art = fmaxf(d1, 0.0f);
  const float det = fmaxf(-d1, 0.0f);
  const float d2 = d * d, art2 = art * art, det2 = det * det;
  v[0] = d;
  v[1] = d2 * d2;
  v[2] = art;
  v[3] = art2 * art2;
  v[4] = det;
  v[5] = det2 * det2;
}

}  // namespace
