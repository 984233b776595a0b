// Block geometry, the deterministic cross-block reduction and the
// reflect-101 border rule shared by the per-level kernels
// (ssimulacra2_scale.cu, ssimulacra2_tail.cu, downscale.cu, windowed.cu,
// vif.cu, adm.cu, blur_probe.cu, integer_vif.cu, integer_adm.cu), and the
// tile geometry, loads and sub-tile tree of the fused level kernels
// (ssimulacra2_scale.cu, windowed.cu, vif.cu, adm.cu, integer_adm.cu).
//
// A level kernel reduces K quantities per block in a fixed tree in f32 and
// writes them as parts (planes, nblk, K); reduce_parts_kernel then sums each
// plane's block partials in f64 in a fixed order (no atomics), so results
// are bit-identical from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// A fused level kernel runs one block of kTileThreads threads per kTileW x
// kTileH output tile of one plane; each warp owns one kBx x kBy tile of
// pixel_grid (its partials' tile), one column per lane.
constexpr int kSubTiles = 4;             // 32x8 partial tiles per block, one per warp
constexpr int kTileW = kBx;              // output columns of a block
constexpr int kTileH = kSubTiles * kBy;  // output rows of a block
constexpr int kTileThreads = 32 * kSubTiles;

// Tree-reduce v[K] over the block's T threads (red: K*T floats of shared
// memory; T a power of two, kThreads unless the block is another size) in a
// fixed order and write the K sums to out[k] (thread 0).  The caller syncs
// the block before it reuses red.
template <int K, int T = kThreads>
__device__ __forceinline__ void tile_partials(const float (&v)[K], float (*red)[T],
                                              float* __restrict__ out) {
  static_assert(T > 0 && (T & (T - 1)) == 0, "the tree halves the block");
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int stride = T / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = red[k][0];
  }
}

// tile_partials of block (blockIdx.x, blockIdx.y), written to
// parts[(plane * nblk + blk) * K + k].
template <int K, int T = kThreads>
__device__ __forceinline__ void block_partials(const float (&v)[K], float (*red)[T],
                                               float* __restrict__ parts, size_t plane) {
  const size_t nblk = (size_t)gridDim.x * gridDim.y;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  tile_partials<K, T>(v, red, parts + (plane * nblk + blk) * K);
}

// The rest of tile_partials' tree for the warp's sub-tile of a fused level
// kernel, where v[o][k] holds quantity k of rows o and o + 4 of this lane's
// column, already added (stride 128 of the tree over position tid = row *
// 32 + column): stride 64 adds row o + 2 to row o, 32 row 1 (in this
// thread), then 16 .. 1 the columns (across the warp; a lane at or past the
// stride adds a value no lane reads) -- the same pairs in the same order as
// tile_partials over a (kBx, kBy) block, so the sums equal a two-pass
// design's bit for bit.  __fadd_rn: tile_partials adds values read back
// from shared memory, so no add may fuse with the caller's last multiplies.
// Lane 0 writes the K sums to parts[((plane * nby + by) * nbx + bx) * K + k]
// (nbx x nby: the plane's pixel_grid) when the sub-tile (bx, by) lies inside
// it.
template <int K>
__device__ __forceinline__ void subtile_partials(float (&v)[kBy / 2][K], float* __restrict__ parts,
                                                 size_t plane, int bx, int by, int nbx, int nby) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[0][k] = __fadd_rn(v[0][k], v[2][k]);
    v[1][k] = __fadd_rn(v[1][k], v[3][k]);
    v[0][k] = __fadd_rn(v[0][k], v[1][k]);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      v[0][k] = __fadd_rn(v[0][k], __shfl_down_sync(0xffffffffu, v[0][k], stride));
    }
  }
  if (threadIdx.x % 32 == 0 && bx >= 0 && bx < nbx && by >= 0 && by < nby) {
    float* out = parts + (plane * nbx * nby + (size_t)by * nbx + bx) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[0][k];
  }
}

// How a kernel reads a plane: through the read-only data cache (__ldg)
// where no block of the same launch writes it, from L2 (__ldcg) where other
// blocks of the same launch wrote it before a grid sync (the persistent
// ssimulacra2_tail.cu: the read-only path is not coherent with such writes).
enum class Src { kReadOnly, kWritten };

template <Src S, typename V>
__device__ __forceinline__ V load_as(const V* p) {
  if constexpr (S == Src::kReadOnly) {
    return __ldg(p);
  } else {
    return __ldcg(p);
  }
}

// Samples gc .. gc+3 of row gr of plane p (h x w), zeros outside the plane:
// one 16-byte load where the four lie inside and are 16-byte aligned (every
// chunk of a plane whose width is a multiple of 4, as at 1080p and 4K), else
// one load each.
template <Src S = Src::kReadOnly>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int h, int w, int gr, int gc) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (gr < 0 || gr >= h) return v;
  const float* q = p + (size_t)gr * w;
  if (gc >= 0 && gc + 3 < w && reinterpret_cast<uintptr_t>(q + gc) % 16 == 0) {
    return load_as<S>(reinterpret_cast<const float4*>(q + gc));
  }
  if (gc >= 0 && gc < w) v.x = load_as<S>(q + gc);
  if (gc + 1 >= 0 && gc + 1 < w) v.y = load_as<S>(q + gc + 1);
  if (gc + 2 >= 0 && gc + 2 < w) v.z = load_as<S>(q + gc + 2);
  if (gc + 3 >= 0 && gc + 3 < w) v.w = load_as<S>(q + gc + 3);
  return v;
}

// One block of kReduceThreads threads: the f64 sum of a plane's nblk block
// partials src[(i * K + k)], in a fixed order, written as f32 to out[k] (out:
// the caller's address for the plane).  The caller syncs the block before it
// calls again.
template <int K>
__device__ __forceinline__ void reduce_plane(const float* __restrict__ src, int nblk,
                                             float* __restrict__ out) {
  __shared__ double red[K][kReduceThreads];
  const int tid = threadIdx.x;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
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
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = (float)red[k][0];
  }
}

// Per-(batch, channel) plane: the f64 sum of its nblk block partials, written
// as f32 to sums[b * sums_bstride + ch * K + k] (plane = b * 3 + ch).
// grid: (planes), block: kReduceThreads
template <int K>
__global__ void __launch_bounds__(kReduceThreads)
reduce_parts_kernel(const float* __restrict__ parts, int nblk, float* __restrict__ sums,
                    int sums_bstride) {
  const int b = blockIdx.x / 3, ch = blockIdx.x % 3;
  reduce_plane<K>(parts + (size_t)blockIdx.x * nblk * K, nblk,
                  sums + (size_t)b * sums_bstride + ch * K);
}

// One plane per frame: its K sums to sums[plane * sums_pstride + k].
// grid: (planes), block: kReduceThreads
template <int K>
__global__ void __launch_bounds__(kReduceThreads)
reduce_frames_kernel(const float* __restrict__ parts, int nblk, float* __restrict__ sums,
                     int sums_pstride) {
  reduce_plane<K>(parts + (size_t)blockIdx.x * nblk * K, nblk,
                  sums + (size_t)blockIdx.x * sums_pstride);
}

// Reflect-101 index of i on an axis of n (ind < 0 -> -ind, ind >= n ->
// 2n-ind-2), repeated with period 2(n-1) where a window is wider than the
// axis, as jnp.pad(mode="reflect") extends.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - m;
}

}  // namespace
