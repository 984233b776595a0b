// SSIM / MS-SSIM windowed statistics of one level on Hopper (sm_90a): the
// 11-tap sigma=1.5 Gaussian correlation over the valid grid, the SSIM map,
// per-channel sums of luminance*cs and of cs, and the next MS-SSIM level.
// Built and bound like ssimulacra2_scale.cu (plain C entry points, caller's
// stream, each returns cudaGetLastError()).
//
// Replaces two TPU kernels of the JAX package:
//   * turbo_metrics_tpu/ops/pallas/windowed.py ssim_sums_pallas (l.400):
//     one level, optional in-kernel 8-bit quantization (level 0 of the
//     multi-metric path reads linear RGB), optional emission of the next
//     level = tm_ssim_level, once;
//   * turbo_metrics_tpu/ops/pallas/windowed_tail.py msssim_tail_pallas
//     (l.376): MS-SSIM levels 1-4 from the emitted level 1 = tm_ssim_level
//     once per level (ops/kernels/windowed_tail.py).
// The TPU kernels' padded (8, 128) layout, bf16 limb splits, band matrices
// and kappa rescale exist for the MXU and are not carried over: the blur is
// 11 f32 FMAs per pass on contiguous (2, B, 3, h, w) planes.
//
// Validity is the *valid-correlation* convention of the SSIM family (map
// centres in [5, h-5) x [5, w-5), no zero extension), unlike SSIMULACRA2's
// zero-extended blur: the row pass writes only the w-10 valid columns and
// the column pass only the h-10 valid rows.
//
// What bounds it on this card: the f32 work and the bytes about equally.  Per
// pixel and channel of the pair the algorithm needs 8 bytes in (and 2 bytes
// out with emission) against ~200 f32 operations (two 11-tap passes over four
// quantities, the map), so at the card's peak rates the operations take
// slightly longer; this design adds the round trip of the four row-blurred
// planes (32 bytes written and read) and a second read of the input for the
// emission, which make it bound by its own traffic.  What the design does
// about it: nothing yet.  s11 + s22 are blurred as one plane a^2 + b^2 (linearity, as the TPU
// kernel does), so four planes suffice; fusing the passes over shared-memory
// row tiles is the first later optimisation.
//
// Layouts (all contiguous):
//   level  (2, B, 3, h, w)          f32: linear RGB in [0, 1] (quantize) or
//                                   8-bit code values and their 2x2 means
//   tmp    (4, B*3, h, w-10)        f32 row-correlated a, b, a^2+b^2, a*b
//   parts  (B*3, nblk, 2)           f32 per-block partial sums
//   sums   (B, [levels,] 3, 2)      f32 (sum luminance*cs, sum cs)
//   ds     (2, B, 3, h/2, w/2)      f32 truncating 2x2 mean (floor halves)

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

// clip(round(x * 255), 0, 255): rintf rounds half to even, as torch.round and
// jnp.round do (roundf would round half away from zero).
__device__ __forceinline__ float quant8(float x) {
  return fminf(fmaxf(rintf(x * 255.0f), 0.0f), 255.0f);
}

template <bool kQuantize>
__device__ __forceinline__ float load(const float* p) {
  const float v = *p;
  return kQuantize ? quant8(v) : v;
}

// ---------------------------------------------------------------------------
// Launch 1: horizontal valid correlation of a, b, a^2 + b^2 and a*b for every
// row and every valid column j in [0, w-10) (window columns j..j+10).
// grid: (ceil((w-10)/kBx), ceil(h/kBy), B*3)
// ---------------------------------------------------------------------------
template <bool kQuantize>
__global__ void __launch_bounds__(kThreads)
ssim_rows_kernel(const float* __restrict__ in, int planes, int h, int w,
                 const float* __restrict__ win, float* __restrict__ tmp) {
  const int wv = w - 2 * kRadius;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int r = blockIdx.y * kBy + threadIdx.y;
  if (r >= h || j >= wv) return;
  const size_t npx = (size_t)h * w;
  const size_t plane = blockIdx.z;
  const float* a = in + plane * npx + (size_t)r * w + j;                    // reference
  const float* b = in + ((size_t)planes + plane) * npx + (size_t)r * w + j;  // distorted
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float t = __ldg(win + k);
    const float av = load<kQuantize>(a + k), bv = load<kQuantize>(b + k);
    s[0] += t * av;
    s[1] += t * bv;
    s[2] += t * (av * av + bv * bv);
    s[3] += t * (av * bv);
  }
  const size_t nv = (size_t)h * wv;
  const size_t at = plane * nv + (size_t)r * wv + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) tmp[q * (size_t)planes * nv + at] = s[q];
}

// ---------------------------------------------------------------------------
// Launch 2: vertical valid correlation (rows i..i+10 for each valid row i in
// [0, h-10)), the SSIM map (Wang et al. 2004) and per-block f32 partial sums
// of luminance*cs and cs (level.cuh block_partials).
// grid: (ceil((w-10)/kBx), ceil((h-10)/kBy), B*3)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssim_cols_kernel(const float* __restrict__ tmp, int planes, int h, int w,
                 const float* __restrict__ win, float c1, float c2, float* __restrict__ parts) {
  __shared__ float red[2][kThreads];
  const int hv = h - 2 * kRadius, wv = w - 2 * kRadius;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  const size_t plane = blockIdx.z;
  float v[2] = {0.0f, 0.0f};
  if (i < hv && j < wv) {
    const size_t nv = (size_t)h * wv;
    const size_t qstride = (size_t)planes * nv;
    const float* base = tmp + plane * nv + (size_t)i * wv + j;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float t = __ldg(win + k);
      const float* row = base + (size_t)k * wv;
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += t * row[q * qstride];
    }
    const float mu1 = s[0], mu2 = s[1], s_sum = s[2], s12 = s[3];
    const float mu1sq = mu1 * mu1, mu2sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float lum = (2.0f * mu12 + c1) / (mu1sq + mu2sq + c1);
    const float cs = (2.0f * (s12 - mu12) + c2) / ((s_sum - mu1sq - mu2sq) + c2);
    v[0] = lum * cs;
    v[1] = cs;
  }
  block_partials<2>(v, red, parts, plane);
}

// ---------------------------------------------------------------------------
// Launch 4 (with emission): the next MS-SSIM level, the 2x2 mean of the
// (quantized) level with odd dimensions truncated (ops/quality.py
// _downsample_2x2).  Exact in f32: the inputs are 8-bit code values or their
// dyadic means.
// grid: (ceil((w/2)/kBx), ceil((h/2)/kBy), 2*B*3)
// ---------------------------------------------------------------------------
template <bool kQuantize>
__global__ void __launch_bounds__(kThreads)
halfpool_kernel(const float* __restrict__ in, int h, int w, float* __restrict__ out) {
  const int h2 = h / 2, w2 = w / 2;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= h2 || j >= w2) return;
  const size_t img = blockIdx.z;
  const float* p = in + img * h * w + (size_t)(2 * i) * w + 2 * j;
  const float top = load<kQuantize>(p) + load<kQuantize>(p + 1);
  const float bottom = load<kQuantize>(p + w) + load<kQuantize>(p + w + 1);
  out[img * h2 * w2 + (size_t)i * w2 + j] = (top + bottom) * 0.25f;
}

}  // namespace

extern "C" {

// Number of per-block partials tm_ssim_level writes for each (batch, channel)
// plane of an h x w level: the caller sizes `parts` as B*3*nblk*2 floats.
int tm_ssim_blocks(int h, int w) {
  const dim3 g = pixel_grid(h - 2 * kRadius, w - 2 * kRadius, 1);
  return (int)(g.x * g.y);
}

// One SSIM level: level (2,B,3,h,w) with h, w >= 11 -> sums[b*sums_bstride +
// ch*2 + k]; with ds non-null also the next level (2,B,3,h/2,w/2).  win: the
// 11 window taps (f32, device); c1, c2: the SSIM stabilisers; tmp holds
// 4*B*3*h*(w-10) floats, parts B*3*tm_ssim_blocks(h,w)*2.
int tm_ssim_level(const float* level, int batch, int h, int w, int quantize, const float* win,
                  float c1, float c2, float* tmp, float* parts, float* sums, int sums_bstride,
                  float* ds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = 3 * batch;
  const dim3 block(kBx, kBy);
  const dim3 rows = pixel_grid(h, w - 2 * kRadius, planes);
  if (quantize) {
    ssim_rows_kernel<true><<<rows, block, 0, s>>>(level, planes, h, w, win, tmp);
  } else {
    ssim_rows_kernel<false><<<rows, block, 0, s>>>(level, planes, h, w, win, tmp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cols = pixel_grid(h - 2 * kRadius, w - 2 * kRadius, planes);
  ssim_cols_kernel<<<cols, block, 0, s>>>(tmp, planes, h, w, win, c1, c2, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<2><<<planes, kReduceThreads, 0, s>>>(parts, (int)(cols.x * cols.y), sums,
                                                           sums_bstride);
  err = cudaGetLastError();
  if (err != cudaSuccess || ds == nullptr) return (int)err;
  const dim3 half = pixel_grid(h / 2, w / 2, 2 * planes);
  if (quantize) {
    halfpool_kernel<true><<<half, block, 0, s>>>(level, h, w, ds);
  } else {
    halfpool_kernel<false><<<half, block, 0, s>>>(level, h, w, ds);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
