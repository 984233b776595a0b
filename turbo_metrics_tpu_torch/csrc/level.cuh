// Block geometry and the deterministic cross-block reduction shared by the
// per-level kernels (ssimulacra2_scale.cu, windowed.cu).
//
// A level kernel reduces K quantities per block in a fixed tree in f32 and
// writes them as parts (planes, nblk, K); reduce_parts_kernel then sums each
// plane's block partials in f64 in a fixed order (no atomics), so results
// are bit-identical from run to run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;  // block width (pixels along a row)
constexpr int kBy = 8;   // block height (rows)
constexpr int kThreads = kBx * kBy;
constexpr int kReduceThreads = 256;

inline dim3 pixel_grid(int h, int w, int planes) {
  return dim3((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, planes);
}

inline dim3 quad_grid(int h, int w, int images) {
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  return dim3((wq + kBx - 1) / kBx, (hq + kBy - 1) / kBy, images);
}

// Tree-reduce v[K] over the block's kThreads threads (red: K*kThreads floats
// of shared memory) and write the block's K sums to
// parts[(plane * nblk + blk) * K + k].
template <int K>
__device__ __forceinline__ void block_partials(const float (&v)[K], float (*red)[kThreads],
                                               float* __restrict__ parts, size_t plane) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const size_t nblk = (size_t)gridDim.x * gridDim.y;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* out = parts + (plane * nblk + blk) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = red[k][0];
  }
}

// Per-(batch, channel) plane: the f64 sum of its nblk block partials, written
// as f32 to sums[b * sums_bstride + ch * K + k] (plane = b * 3 + ch).
// grid: (planes), block: kReduceThreads
template <int K>
__global__ void __launch_bounds__(kReduceThreads)
reduce_parts_kernel(const float* __restrict__ parts, int nblk, float* __restrict__ sums,
                    int sums_bstride) {
  __shared__ double red[K][kReduceThreads];
  const int plane = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  const float* src = parts + (size_t)plane * nblk * K;
  for (int i = tid; i < nblk; i += kReduceThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += (double)src[(size_t)i * K + k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int b = plane / 3, ch = plane % 3;
    float* out = sums + (size_t)b * sums_bstride + ch * K;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = (float)red[k][0];
  }
}

}  // namespace
