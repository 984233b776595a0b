// One ADM level on Hopper (sm_90a): the db2 DWT of a (reference, distorted)
// luma pair, the 1-degree angle gate, decoupling and CSF weighting of the
// three detail bands, the 3x3 contrast-masking threshold and the centre-
// region cube sums, per frame.  Built and bound like the other sources
// (plain C entry point, caller's stream, returns cudaGetLastError()).
//
// Replaces the JAX package's _adm_level_run (turbo_metrics_tpu/ops/pallas/
// adm.py:442; its DWT + decouple + CSF kernel at l.470 and its mask + cube
// sums kernel at l.510), behind adm_stats_pallas (l.420): tm_adm_level once
// per level (ops/kernels/adm.py adm_stats).  The math is that of the jnp
// path, turbo_metrics_tpu/ops/adm.py (ported as ops/adm.py), which the JAX
// package runs by default; the Pallas kernels have drifted from it.
//
// Conventions: half-sample symmetric extension (x[-1] = x[0], x[n] =
// x[n-1], period 2n), output index i reads input 2i - 1 + tap, ceil(n/2)
// outputs; the mask filter reflects 101 (level.cuh reflect101).
//
// Numerics: every operation is written with an explicit rounding intrinsic,
// so nothing is contracted into FMAs and every band, gate and masked value
// is the f32 value of the plain version's expression order (ops/adm.py).
// The angle gate (dot >= 0 and dot^2 >= cos^2(1 deg) |o|^2 |t|^2) is
// discontinuous; evaluated in the same order it flips no pixel against the
// plain version.  The cube sums span many magnitudes: f32 per block, then
// f64 (level.cuh).
//
// What bounds it on this card: device-memory traffic.  Per pixel of the pair
// at level 0 the algorithm needs 8 bytes in (and 2 bytes out, the next
// level's approximation bands) against ~40 f32 operations.  This first
// design adds the round trips of the row-filtered planes and of nine
// band planes (|csf*a|, |csf*r|, |csf*o| per band) between its launches;
// fusing the DWT's two passes and the mask over shared-memory tiles is the
// first later optimisation.
//
// Layouts (all contiguous; ch = ceil(h/2), cw = ceil(w/2)):
//   in     (2, B, h, w)      f32 luma in 8-bit units, or the previous level's A bands
//   rows   (2, 2, B, h, cw)  f32 row-filtered lo, hi of ref and dis
//   approx (2, B, ch, cw)    f32 the A bands of ref and dis (the next level's input)
//   bands  (9, B, ch, cw)    f32 |csf*a|, |csf*r|, |csf*o| of bands H, V, D
//   parts  (B, nblk, 6)      f32 per-block partial cube sums
//   sums   (B, ...)          f32 at sums[b * sums_pstride + band * 2 + {0 num, 1 den}]

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr int kTaps = 4;

struct AdmConsts {
  float lo[kTaps], hi[kTaps];  // db2 analysis taps
  float rf_hv, rf_d;           // CSF factors of the H/V and D bands
  float cos1, eps;             // cos^2(1 deg), the decoupling epsilon
  float m_centre, m_edge;      // mask filter weights 1/15, 1/30
};

__device__ __forceinline__ int symmetric(int i, int n) {
  if (i >= 0 && i < n) return i;
  int m = i % (2 * n);
  if (m < 0) m += 2 * n;
  return m < n ? m : 2 * n - 1 - m;
}

// taps . x[sym(2i - 1 + k)], as acc = x0*t0; acc = acc + xk*tk.
template <typename Load>
__device__ __forceinline__ float dec(const float (&taps)[kTaps], int i, int n, Load load) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float x = __fmul_rn(load(symmetric(2 * i - 1 + k, n)), taps[k]);
    acc = k == 0 ? x : __fadd_rn(acc, x);
  }
  return acc;
}

// Launch 1: the row pass (lo and hi) of both images.  grid: pixel_grid(h, cw, 2B)
__global__ void __launch_bounds__(kThreads)
adm_rows_kernel(const float* __restrict__ in, int h, int w, AdmConsts c, float* __restrict__ rows) {
  const int cw = (w + 1) / 2;
  const int i = blockIdx.x * kBx + threadIdx.x;
  const int r = blockIdx.y * kBy + threadIdx.y;
  if (r >= h || i >= cw) return;
  const size_t img = blockIdx.z;
  const float* x = in + (img * h + r) * w;
  auto load = [x](int k) { return x[k]; };
  const size_t at = (img * h + r) * cw + i;
  const size_t plane = (size_t)gridDim.z * h * cw;
  rows[at] = dec(c.lo, i, w, load);
  rows[plane + at] = dec(c.hi, i, w, load);
}

// Launch 2: the column pass (A, H, V, D of both images), the angle gate,
// decoupling and CSF (ops/adm.py decouple, in its order).
// grid: pixel_grid(ch, cw, B)
__global__ void __launch_bounds__(kThreads)
adm_cols_kernel(const float* __restrict__ rows, int bsz, int h, int w, AdmConsts c,
                float* __restrict__ approx, float* __restrict__ bands) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ch || j >= cw) return;
  const size_t rplane = (size_t)2 * bsz * h * cw;
  const size_t nb = (size_t)ch * cw;
  float det[2][3];  // (o, t) x (H, V, D)
#pragma unroll
  for (int im = 0; im < 2; ++im) {
    const size_t img = (size_t)im * bsz + b;
    const float* lo = rows + img * h * cw + j;
    const float* hi = rows + rplane + img * h * cw + j;
    auto load_lo = [lo, cw](int k) { return lo[(size_t)k * cw]; };
    auto load_hi = [hi, cw](int k) { return hi[(size_t)k * cw]; };
    if (approx != nullptr) approx[img * nb + (size_t)i * cw + j] = dec(c.lo, i, h, load_lo);
    det[im][0] = dec(c.lo, i, h, load_hi);  // horizontal detail
    det[im][1] = dec(c.hi, i, h, load_lo);  // vertical detail
    det[im][2] = dec(c.hi, i, h, load_hi);  // diagonal detail
  }
  const float o_h = det[0][0], o_v = det[0][1], t_h = det[1][0], t_v = det[1][1];
  const float ot_dp = __fadd_rn(__fmul_rn(o_h, t_h), __fmul_rn(o_v, t_v));
  const float o_mag_sq = __fadd_rn(__fmul_rn(o_h, o_h), __fmul_rn(o_v, o_v));
  const float t_mag_sq = __fadd_rn(__fmul_rn(t_h, t_h), __fmul_rn(t_v, t_v));
  const bool angle_ok =
      ot_dp >= 0.0f && __fmul_rn(ot_dp, ot_dp) >= __fmul_rn(__fmul_rn(c.cos1, o_mag_sq), t_mag_sq);
  const size_t at = (size_t)b * nb + (size_t)i * cw + j;
  const size_t bstride = (size_t)bsz * nb;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float o = det[0][q], t = det[1][q];
    const float rf = q == 2 ? c.rf_d : c.rf_hv;
    const float k = fminf(fmaxf(__fdiv_rn(t, __fadd_rn(o, c.eps)), 0.0f), 1.0f);
    const float r = angle_ok ? t : __fmul_rn(k, o);
    bands[(0 + q) * bstride + at] = fabsf(__fmul_rn(rf, __fsub_rn(t, r)));
    bands[(3 + q) * bstride + at] = fabsf(__fmul_rn(rf, r));
    bands[(6 + q) * bstride + at] = fabsf(__fmul_rn(rf, o));
  }
}

// Launch 3: the masking threshold (three 3x3 filters over |csf*a|, reflect
// 101, summed) and the cube sums of the masked |csf*r| and of |csf*o| over
// the centre region [top, ch-top) x [left, cw-left), per-block partials.
// grid: pixel_grid(ch - 2 top, cw - 2 left, B)
__global__ void __launch_bounds__(kThreads)
adm_mask_kernel(const float* __restrict__ bands, int bsz, int ch, int cw, int top, int left,
                AdmConsts c, float* __restrict__ parts) {
  __shared__ float red[6][kThreads];
  const int j = left + blockIdx.x * kBx + threadIdx.x;
  const int i = top + blockIdx.y * kBy + threadIdx.y;
  const int b = blockIdx.z;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < ch - top && j < cw - left) {
    const size_t nb = (size_t)ch * cw;
    const size_t bstride = (size_t)bsz * nb;
    const float* plane0 = bands + (size_t)b * nb;
    float thr = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* a = plane0 + q * bstride;
      float m = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = a + (size_t)reflect101(i - 1 + dy, ch) * cw;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float f = (dy == 1 && dx == 1) ? c.m_centre : c.m_edge;
          const float x = __fmul_rn(row[reflect101(j - 1 + dx, cw)], f);
          m = (dy == 0 && dx == 0) ? x : __fadd_rn(m, x);
        }
      }
      thr = q == 0 ? m : __fadd_rn(thr, m);
    }
    const size_t at = (size_t)i * cw + j;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float rm = fmaxf(__fsub_rn(plane0[(3 + q) * bstride + at], thr), 0.0f);
      const float oc = plane0[(6 + q) * bstride + at];
      v[2 * q] = __fmul_rn(__fmul_rn(rm, rm), rm);
      v[2 * q + 1] = __fmul_rn(__fmul_rn(oc, oc), oc);
    }
  }
  block_partials<6>(v, red, parts, b);
}

}  // namespace

extern "C" {

// Number of per-block partials tm_adm_level writes per frame for an h x w
// input (its bands' centre region): the caller sizes `parts` as
// B*nblk*6 floats.
int tm_adm_blocks(int ch, int cw, int top, int left) {
  const dim3 g = pixel_grid(ch - 2 * top, cw - 2 * left, 1);
  return (int)(g.x * g.y);
}

// One ADM level of the pair `in` (2, B, h, w): sums[b * sums_pstride + band *
// 2 + {0, 1}] = (sum |masked csf*r|^3, sum |csf*o|^3) over the bands' centre
// region (top, left: its crop per side); with approx non-null also the A
// bands (2, B, ch, cw).  taps: db2 lo[4] then hi[4]; rf_hv, rf_d: the CSF
// factors; cos1: cos^2(1 deg); eps: the decoupling epsilon; m_centre,
// m_edge: the mask weights.  Scratch: rows 4*B*h*cw floats, bands 9*B*ch*cw,
// parts B*tm_adm_blocks(...)*6.
int tm_adm_level(const float* in, int bsz, int h, int w, const float* taps, float rf_hv,
                 float rf_d, float cos1, float eps, float m_centre, float m_edge, int top,
                 int left, float* rows, float* approx, float* bands, float* parts, float* sums,
                 int sums_pstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AdmConsts c;
  for (int k = 0; k < kTaps; ++k) {
    c.lo[k] = taps[k];
    c.hi[k] = taps[kTaps + k];
  }
  c.rf_hv = rf_hv;
  c.rf_d = rf_d;
  c.cos1 = cos1;
  c.eps = eps;
  c.m_centre = m_centre;
  c.m_edge = m_edge;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const dim3 block(kBx, kBy);
  adm_rows_kernel<<<pixel_grid(h, cw, 2 * bsz), block, 0, s>>>(in, h, w, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adm_cols_kernel<<<pixel_grid(ch, cw, bsz), block, 0, s>>>(rows, bsz, h, w, c, approx, bands);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g = pixel_grid(ch - 2 * top, cw - 2 * left, bsz);
  adm_mask_kernel<<<g, block, 0, s>>>(bands, bsz, ch, cw, top, left, c, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<6><<<bsz, kReduceThreads, 0, s>>>(parts, (int)(g.x * g.y), sums,
                                                         sums_pstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
