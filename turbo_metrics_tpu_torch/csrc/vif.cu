// One VIF scale on Hopper (sm_90a): the five reflect-101 Gaussian blurs of a
// (reference, distorted) luma pair (mu1, mu2, blur(ref^2), blur(dis^2),
// blur(ref*dis)), the guarded num/den map with its two log2, per-frame sums
// of num and den, and, optionally, the next scale's input decimate2(blur(x,
// next window)).  Built and bound like the other sources (plain C entry
// point, caller's stream, returns cudaGetLastError()).
//
// Replaces two TPU kernels of the JAX package:
//   * turbo_metrics_tpu/ops/pallas/vif.py _vif_scale_pallas (l.540), the
//     scale-0 launch of vif_scale_stats_pallas (l.664) = tm_vif_level at
//     scale 0 (17 taps) emitting level 1 (ops/kernels/vif.py vif_scale0);
//   * turbo_metrics_tpu/ops/pallas/vif_tail.py vif_tail_pallas (l.331):
//     scales 1-3 from the emitted level 1 = tm_vif_level at scales 1, 2, 3
//     (9, 5, 3 taps), each emitting the next (ops/kernels/vif.py vif_tail).
// The TPU kernels' band matrices, bf16 limb splits, kappa rescale and padded
// layouts with host-side mirror halos exist for the MXU and are not carried
// over: here each output reads its reflect-101 indices directly (ind < 0 ->
// -ind, ind >= n -> 2n-ind-2, level.cuh reflect101).
//
// Numerics: every operation is written with an explicit rounding intrinsic
// (__fmul_rn, __fadd_rn, ...), so the compiler contracts nothing into FMAs
// and each blur, product and guard is the f32 value of the plain version's
// expression order (ops/vif.py); only the sums (f32 per block, then f64)
// and log2f's last bit differ.  The s11 < EPS guard is discontinuous, so
// this keeps the kernel on the same side of it as the plain version.
//
// What bounds it on this card: the f32 work.  Per pixel of the pair at scale
// 0 the algorithm needs 8 bytes in against ~390 f32 operations (five
// quantities, 17 taps, two passes; the map; the emission at a quarter of the
// pixels).  This first design trades bytes for simplicity: a row pass writes
// the five row-blurred planes (and the two emission planes at even columns)
// to device memory and a column pass reads them back, so its own traffic
// (~56 bytes per pixel at scale 0) bounds it.  Fusing the passes over a
// shared-memory tile is the first later optimisation.
//
// Layouts (all contiguous):
//   in     (2, B, h, w)          f32 luma in 8-bit units (reference, distorted)
//   tmp    (5, B, h, w)          f32 row-blurred ref, dis, ref^2, dis^2, ref*dis
//   tmp_e  (2, B, h, ceil(w/2))  f32 row-blurred (next window) ref, dis at even columns
//   parts  (B, nblk, 2)          f32 per-block partial sums
//   sums   (B, ...)              f32 num, den at sums[b * sums_pstride + {0, 1}]
//   next   (2, B, ceil(h/2), ceil(w/2)) f32 the next scale's input

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr float kEps = 1e-10f;
constexpr float kSigmaNsq = 2.0f;

// Launch 1: the row pass of the five quantities with the window of radius R
// and, with RE > 0, of ref and dis with the next window (radius RE) at even
// columns.  grid: pixel_grid(h, w, B)
template <int R, int RE>
__global__ void __launch_bounds__(kThreads)
vif_rows_kernel(const float* __restrict__ in, int bsz, int h, int w, const float* __restrict__ win,
                const float* __restrict__ win_e, float* __restrict__ tmp, float* __restrict__ tmp_e) {
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int r = blockIdx.y * kBy + threadIdx.y;
  const int b = blockIdx.z;
  if (r >= h || j >= w) return;
  const size_t npx = (size_t)h * w;
  const float* a = in + (size_t)b * npx + (size_t)r * w;
  const float* d = in + ((size_t)bsz + b) * npx + (size_t)r * w;
  float s[5];
#pragma unroll
  for (int k = 0; k < 2 * R + 1; ++k) {
    const int c = reflect101(j - R + k, w);
    const float t = __ldg(win + k), av = a[c], dv = d[c];
    const float x[5] = {av, dv, __fmul_rn(av, av), __fmul_rn(dv, dv), __fmul_rn(av, dv)};
#pragma unroll
    for (int q = 0; q < 5; ++q) s[q] = k == 0 ? __fmul_rn(t, x[q]) : __fadd_rn(s[q], __fmul_rn(t, x[q]));
  }
  const size_t at = (size_t)b * npx + (size_t)r * w + j;
  const size_t qstride = (size_t)bsz * npx;
#pragma unroll
  for (int q = 0; q < 5; ++q) tmp[q * qstride + at] = s[q];
  if (RE > 0 && (j & 1) == 0) {
    const int we = (w + 1) / 2;
    float e[2];
#pragma unroll
    for (int k = 0; k < 2 * RE + 1; ++k) {
      const int c = reflect101(j - RE + k, w);
      const float t = __ldg(win_e + k);
      e[0] = k == 0 ? __fmul_rn(t, a[c]) : __fadd_rn(e[0], __fmul_rn(t, a[c]));
      e[1] = k == 0 ? __fmul_rn(t, d[c]) : __fadd_rn(e[1], __fmul_rn(t, d[c]));
    }
    const size_t ne = (size_t)h * we;
    const size_t at_e = (size_t)b * ne + (size_t)r * we + j / 2;
    tmp_e[at_e] = e[0];
    tmp_e[(size_t)bsz * ne + at_e] = e[1];
  }
}

// Launch 2: the column pass, the guarded map (ops/vif.py scale_sums, in its
// order) and per-block partial sums of num and den.  grid: pixel_grid(h, w, B)
template <int R>
__global__ void __launch_bounds__(kThreads)
vif_cols_kernel(const float* __restrict__ tmp, int bsz, int h, int w, const float* __restrict__ win,
                float* __restrict__ parts) {
  __shared__ float red[2][kThreads];
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  const int b = blockIdx.z;
  float v[2] = {0.0f, 0.0f};
  if (i < h && j < w) {
    const size_t npx = (size_t)h * w;
    const size_t qstride = (size_t)bsz * npx;
    const float* base = tmp + (size_t)b * npx + j;
    float s[5];
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) {
      const float* row = base + (size_t)reflect101(i - R + k, h) * w;
      const float t = __ldg(win + k);
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const float x = __fmul_rn(t, row[q * qstride]);
        s[q] = k == 0 ? x : __fadd_rn(s[q], x);
      }
    }
    const float mu1 = s[0], mu2 = s[1];
    const float s11 = fmaxf(__fsub_rn(s[2], __fmul_rn(mu1, mu1)), 0.0f);
    const float s22 = fmaxf(__fsub_rn(s[3], __fmul_rn(mu2, mu2)), 0.0f);
    const float s12 = __fsub_rn(s[4], __fmul_rn(mu1, mu2));
    float g = __fdiv_rn(s12, __fadd_rn(s11, kEps));
    float sv_sq = __fsub_rn(s22, __fmul_rn(g, s12));
    // Guards (order matters, mirroring the classic implementation).
    if (s11 < kEps) g = 0.0f;
    if (s11 < kEps) sv_sq = s22;
    const float s11c = s11 < kEps ? 0.0f : s11;
    if (s22 < kEps) sv_sq = 0.0f;
    if (s22 < kEps) g = 0.0f;
    if (g < 0.0f) sv_sq = s22;
    g = fmaxf(g, 0.0f);
    sv_sq = fmaxf(sv_sq, kEps);
    v[0] = log2f(__fadd_rn(1.0f, __fdiv_rn(__fmul_rn(__fmul_rn(g, g), s11c), __fadd_rn(sv_sq, kSigmaNsq))));
    v[1] = log2f(__fadd_rn(1.0f, __fdiv_rn(s11c, kSigmaNsq)));
  }
  block_partials<2>(v, red, parts, b);
}

// Launch 3 (with emission): the column pass of the next window at even rows:
// next = decimate2(blur(x, next window)).  grid: pixel_grid(ceil(h/2), ceil(w/2), 2B)
template <int RE>
__global__ void __launch_bounds__(kThreads)
vif_emit_kernel(const float* __restrict__ tmp_e, int h, int w, const float* __restrict__ win_e,
                float* __restrict__ next) {
  const int he = (h + 1) / 2, we = (w + 1) / 2;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= he || j >= we) return;
  const size_t img = blockIdx.z;
  const float* base = tmp_e + img * h * we + j;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * RE + 1; ++k) {
    const float x = __fmul_rn(__ldg(win_e + k), base[(size_t)reflect101(2 * i - RE + k, h) * we]);
    s = k == 0 ? x : __fadd_rn(s, x);
  }
  next[img * he * we + (size_t)i * we + j] = s;
}

template <int R, int RE>
int launch_scale(const float* in, int bsz, int h, int w, const float* win, const float* win_e,
                 float* tmp, float* tmp_e, float* parts, float* sums, int sums_pstride,
                 float* next, cudaStream_t s) {
  const dim3 block(kBx, kBy);
  const dim3 grid = pixel_grid(h, w, bsz);
  vif_rows_kernel<R, RE><<<grid, block, 0, s>>>(in, bsz, h, w, win, win_e, tmp, tmp_e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vif_cols_kernel<R><<<grid, block, 0, s>>>(tmp, bsz, h, w, win, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<2><<<bsz, kReduceThreads, 0, s>>>(parts, (int)(grid.x * grid.y), sums,
                                                         sums_pstride);
  err = cudaGetLastError();
  if (err != cudaSuccess || RE == 0) return (int)err;
  const dim3 half = pixel_grid((h + 1) / 2, (w + 1) / 2, 2 * bsz);
  vif_emit_kernel<(RE > 0 ? RE : 1)><<<half, block, 0, s>>>(tmp_e, h, w, win_e, next);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials tm_vif_level writes per frame of an h x w
// scale: the caller sizes `parts` as B*nblk*2 floats.
int tm_vif_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// VIF scale `scale` (0-3, window 2^(4-scale)+1 taps `win`) of the pair `in`
// (2, B, h, w) -> sums[b * sums_pstride + {0, 1}] = (num, den).  With scale
// < 3 it also writes `next` (2, B, ceil(h/2), ceil(w/2)) = decimate2(blur(in,
// win_e)), win_e the next scale's window (at scale 3 win_e, tmp_e and next
// are unused and may be null).  Scratch: tmp 5*B*h*w floats, tmp_e
// 2*B*h*ceil(w/2), parts B*tm_vif_blocks(h, w)*2.
int tm_vif_level(const float* in, int bsz, int h, int w, int scale, const float* win,
                 const float* win_e, float* tmp, float* tmp_e, float* parts, float* sums,
                 int sums_pstride, float* next, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 0: return launch_scale<8, 4>(in, bsz, h, w, win, win_e, tmp, tmp_e, parts, sums, sums_pstride, next, s);
    case 1: return launch_scale<4, 2>(in, bsz, h, w, win, win_e, tmp, tmp_e, parts, sums, sums_pstride, next, s);
    case 2: return launch_scale<2, 1>(in, bsz, h, w, win, win_e, tmp, tmp_e, parts, sums, sums_pstride, next, s);
    case 3: return launch_scale<1, 0>(in, bsz, h, w, win, win_e, tmp, tmp_e, parts, sums, sums_pstride, next, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
