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
// zero-extended blur: output (i, j) of the valid grid correlates input rows
// i .. i+10 and columns j .. j+10, so no tap reads outside the plane.
//
// A level is one launch of ssim_tile_kernel (both correlation passes, the
// map, the per-32x8-tile partials and the emission of the next level), then
// the f64 reduction of the partials (level.cuh reduce_parts_kernel).
//
// Only a window [clo, chi) of the valid grid's columns adds to the sums (0
// and w-10: all of them).  A column strip of a frame cut with a halo
// (parallel/mesh.py spatial_sharding) correlates and emits every column it
// holds but sums only the outputs centred on its own columns: output j is
// centred on input column j + 5, so the strip's owned input columns
// [lo, hi) give the window [lo - 5, hi - 5) clipped to the grid
// (ops/kernels/windowed.py valid_window).  A tile wholly outside the window
// skips its correlation passes and map and writes zero partials, the bits
// its pass would write; it still emits its part of the next level.
//
// What bounds it on this card: the f32 work.  Per pixel and channel of the
// pair the algorithm needs 8 bytes in (and 2 bytes out with emission)
// against ~200 f32 operations (two 11-tap passes over four quantities, the
// map), so at the card's peak rates the operations take longer than the
// bytes; the row pass also reads 22 shared values per output.  What the
// design does about it, after level_tile_kernel (ssimulacra2_scale.cu):
//   * one block of 128 threads per 32x32 output tile of one (batch,
//     channel) plane; the tile's input rows y0 .. y0+41 and columns
//     x0 .. x0+43 of both images go to shared memory with 16-byte loads
//     (single loads where a chunk is unaligned or hangs over the plane's
//     edge, zeros outside), eight per thread, all issued before the first
//     store, quantized as they are stored;
//   * the row pass of a, b, a^2+b^2 and a*b over the 42 input rows stays in
//     shared memory (4 x 42 x 32 f32) and never reaches device memory;
//     36,288 B of static shared memory in all;
//   * register blocking in the column pass: each thread computes one column
//     of one 32x8 sub-tile, eight outputs from an 18-row window;
//   * each warp owns one 32x8 sub-tile, so level.cuh's fixed partial tree
//     runs in registers and warp shuffles, the same pairs in the same order
//     as tile_partials over a (32, 8) block;
//   * the emission reads the (quantized) input already in shared memory:
//     the next level is the truncating 2x2 mean of the level, so tile t
//     writes the next level's rows and columns [16t, 16t+16) and the last
//     tile of each direction the rest, which its 42-row footprint reaches
//     (y0 = 32(T-1) >= h-42).  The level is read from device memory once.
// s11 + s22 are correlated as one plane a^2 + b^2 (linearity, as the TPU
// kernel does), so four planes suffice.
//
// Layouts (all contiguous):
//   level  (2, B, 3, h, w)          f32: linear RGB in [0, 1] (quantize) or
//                                   8-bit code values and their 2x2 means
//   parts  (B*3, nblk, 2)           f32 per-32x8-tile partial sums over the
//                                   (h-10) x (w-10) valid grid
//   sums   (B, [levels,] 3, 2)      f32 (sum luminance*cs, sum cs)
//   ds     (2, B, 3, h/2, w/2)      f32 truncating 2x2 mean (floor halves)

#include <cuda_runtime.h>

#include "level.cuh"

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

// clip(round(x * 255), 0, 255): rintf rounds half to even, as torch.round and
// jnp.round do (roundf would round half away from zero).
__device__ __forceinline__ float quant8(float x) {
  return fminf(fmaxf(rintf(x * 255.0f), 0.0f), 255.0f);
}

// One tap t of the row pass on the reference's sample av and the distorted
// image's bv: s accumulates a, b, a^2 + b^2, a*b.  Callers run k = 0..10 in
// order from s = 0.
__device__ __forceinline__ void ssim_row_tap(float (&s)[4], float t, float av, float bv) {
  s[0] += t * av;
  s[1] += t * bv;
  s[2] += t * (av * av + bv * bv);
  s[3] += t * (av * bv);
}

// One tap t of the column pass on the four row sums x of one row.
__device__ __forceinline__ void ssim_col_tap(float (&s)[4], float t, const float (&x)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] += t * x[q];
}

// The SSIM map (Wang et al. 2004) of one valid pixel from its correlated
// mu1, mu2, a^2 + b^2 and a*b: v = (luminance * cs, cs).
__device__ __forceinline__ void ssim_map(const float (&s)[4], float c1, float c2, float (&v)[2]) {
  const float mu1 = s[0], mu2 = s[1], s_sum = s[2], s12 = s[3];
  const float mu1sq = mu1 * mu1, mu2sq = mu2 * mu2, mu12 = mu1 * mu2;
  const float lum = (2.0f * mu12 + c1) / (mu1sq + mu2sq + c1);
  const float cs = (2.0f * (s12 - mu12) + c2) / ((s_sum - mu1sq - mu2sq) + c2);
  v[0] = lum * cs;
  v[1] = cs;
}

constexpr int kHaloH = kTileH + 2 * kRadius;   // input rows of a tile (y0 .. y0+41)
constexpr int kInW = kTileW + 12;              // input columns held (x0 .. x0+43; .. x0+41 used)
constexpr int kInFloats = kHaloH * kInW;       // one image's input tile
constexpr int kRowFloats = kHaloH * kTileW;    // one row-correlated quantity
constexpr int kColWin = kBy + 2 * kRadius;     // rows of a thread's column window
// Four-float loads per thread: all issued before the first is stored.
constexpr int kChunks = 2 * kInFloats / 4;
constexpr int kLoadsPerThread = (kChunks + kTileThreads - 1) / kTileThreads;

template <bool kQuantize>
__device__ __forceinline__ float4 quant4(float4 v) {
  if (kQuantize) {
    v.x = quant8(v.x);
    v.y = quant8(v.y);
    v.z = quant8(v.z);
    v.w = quant8(v.w);
  }
  return v;
}

// ---------------------------------------------------------------------------
// One block per 32x32 tile of the valid grid of plane blockIdx.z (b*3 + ch):
// the tile's 42x44 input samples of both images into shared memory
// (quantized with kQuantize), the row pass into shared memory, the column
// pass and the map, and each 32x8 sub-tile's two partials into
// parts[((b*3 + ch) * nblk + blk) * 2 + k], blk = its index in the valid
// grid's (ceil((h-10)/8), ceil((w-10)/32)) grid of 32x8 tiles
// (reduce_parts_kernel<2> then sums them in f64), only the outputs of the
// valid grid's columns [clo, chi) adding; with ds non-null also the tile's
// part of the next level.
// grid: (ceil((w-10)/32), ceil((h-10)/32), B*3), block: kTileThreads (1-D).
// ---------------------------------------------------------------------------
template <bool kQuantize>
__global__ void __launch_bounds__(kTileThreads)
ssim_tile_kernel(const float* __restrict__ level, int planes, int h, int w, int clo, int chi,
                 const float* __restrict__ win, float c1, float c2, float* __restrict__ parts,
                 float* __restrict__ ds) {
  __shared__ __align__(16) float in[2 * kInFloats];  // [2 images][kHaloH][kInW]
  __shared__ float rows[4 * kRowFloats];             // [4 quantities][kHaloH][kTileW]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int hv = h - 2 * kRadius, wv = w - 2 * kRadius;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t plane = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const int nbx = (wv + kBx - 1) / kBx, nby = (hv + kBy - 1) / kBy;
  const int by = blockIdx.y * kSubTiles + warp;  // this warp's sub-tile row in that grid
  const int c = x0 + lane;                       // this thread's output column
  // The whole block: the tile's 32 output columns all lie outside the window.
  const bool outside = x0 + kTileW <= clo || x0 >= chi;
  float v[kBy / 2][2];
  if (outside && ds == nullptr) {
#pragma unroll
    for (int o = 0; o < kBy / 2; ++o) v[o][0] = v[o][1] = 0.0f;
    subtile_partials<2>(v, parts, plane, blockIdx.x, by, nbx, nby);
    return;
  }

  // Input tiles: rows y0 .. y0+41, columns x0 .. x0+43 of both planes.
  {
    const float* a = level + plane * npx;
    const float* b = level + ((size_t)planes + plane) * npx;
    float4 ld[kLoadsPerThread];
#pragma unroll
    for (int n = 0; n < kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;  // chunk: 4 floats of the two tiles
      const int img = i / (kInFloats / 4), rem = 4 * i - img * kInFloats;
      const int r = rem / kInW;
      ld[n] = i < kChunks ? load4(img ? b : a, h, w, y0 + r, x0 + rem - r * kInW)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int n = 0; n < kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;
      if (i < kChunks) reinterpret_cast<float4*>(in)[i] = quant4<kQuantize>(ld[n]);
    }
  }
  float t[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) t[k] = __ldg(win + k);
  __syncthreads();

  // Row pass: every input row of the tile, one output column per lane
  // (none outside the window).
  for (int r = warp; r < kHaloH && !outside; r += kSubTiles) {
    const float* p = in + r * kInW + lane;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) ssim_row_tap(s, t[k], p[k], p[k + kInFloats]);
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[(q * kHaloH + r) * kTileW + lane] = s[q];
  }

  // The next level: the truncating 2x2 mean of the tile's input rows and
  // columns [32t, 32t+32), and in the last tile of a direction the rest.
  if (ds != nullptr) {
    const int h2 = h / 2, w2 = w / 2;
    const int i0 = y0 / 2, j0 = x0 / 2;
    const int i1 = blockIdx.y + 1 == gridDim.y ? h2 : min(i0 + kTileH / 2, h2);
    const int j1 = blockIdx.x + 1 == gridDim.x ? w2 : min(j0 + kTileW / 2, w2);
    const int nc = j1 - j0, n = (i1 - i0) * nc;
    for (int idx = threadIdx.x; idx < 2 * n; idx += kTileThreads) {
      const int img = idx >= n, rem = idx - img * n;
      const int ii = rem / nc, jj = rem - ii * nc;
      const float* p = in + img * kInFloats + (2 * ii) * kInW + 2 * jj;
      const float top = p[0] + p[1];
      const float bottom = p[kInW] + p[kInW + 1];
      ds[((img * (size_t)planes + plane) * h2 + i0 + ii) * w2 + j0 + jj] = (top + bottom) * 0.25f;
    }
  }
  __syncthreads();
  if (outside) {
#pragma unroll
    for (int o = 0; o < kBy / 2; ++o) v[o][0] = v[o][1] = 0.0f;
    subtile_partials<2>(v, parts, plane, blockIdx.x, by, nbx, nby);
    return;
  }

  // Column pass: column `lane` of the warp's sub-tile, eight outputs from
  // one window of kColWin rows, each summed over k = 0..10 in order.
  float s[kBy][4];
#pragma unroll
  for (int o = 0; o < kBy; ++o) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[o][q] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kColWin; ++i) {
    const float* rp = rows + (warp * kBy + i) * kTileW + lane;
    const float x[4] = {rp[0], rp[kRowFloats], rp[2 * kRowFloats], rp[3 * kRowFloats]};
#pragma unroll
    for (int o = 0; o < kBy; ++o) {
      if (i - o >= 0 && i - o < kTaps) ssim_col_tap(s[o], t[i - o], x);
    }
  }

  // The map, rows o and o + 4 added (the first stride of level.cuh's tree),
  // then the rest of the sub-tile's tree.  chi <= wv: an owned column is a
  // valid one.
  const bool owned = c >= clo && c < chi;
#pragma unroll
  for (int o = 0; o < kBy / 2; ++o) {
    float va[2] = {0.0f, 0.0f}, vb[2] = {0.0f, 0.0f};
    const int ra = y0 + warp * kBy + o, rb = ra + kBy / 2;
    if (ra < hv && owned) ssim_map(s[o], c1, c2, va);
    if (rb < hv && owned) ssim_map(s[o + kBy / 2], c1, c2, vb);
#pragma unroll
    for (int k = 0; k < 2; ++k) v[o][k] = __fadd_rn(va[k], vb[k]);
  }
  subtile_partials<2>(v, parts, plane, blockIdx.x, by, nbx, nby);
}

int ssim_blocks(int h, int w) {
  const dim3 g = pixel_grid(h - 2 * kRadius, w - 2 * kRadius, 1);
  return (int)(g.x * g.y);
}

template <bool kQuantize>
int tile_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, ssim_tile_kernel<kQuantize>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssim_tile_kernel<kQuantize>,
                                                        kTileThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// Number of 32x8-tile partials tm_ssim_level writes for each (batch,
// channel) plane of an h x w level (tiles of the (h-10) x (w-10) valid
// grid): the caller sizes `parts` as B*3*nblk*2 floats.
int tm_ssim_blocks(int h, int w) { return ssim_blocks(h, w); }

// What ssim_tile_kernel<quantize> takes on this card: out[0] registers per
// thread, out[1] shared memory per block in bytes, out[2] resident blocks
// per SM, out[3] local memory per thread in bytes (spills).
int tm_ssim_tile_attrs(int quantize, int* out) {
  return quantize ? tile_attrs<true>(out) : tile_attrs<false>(out);
}

// One SSIM level: level (2,B,3,h,w) with h, w >= 11 -> sums[b*sums_bstride +
// ch*2 + k] over the valid grid's columns [clo, chi) (0 <= clo <= chi <=
// w-10; 0 and w-10: the whole level; clo == chi: zeros); with ds non-null
// also the next level (2,B,3,h/2,w/2), whole.  win: the 11 window taps (f32,
// device); c1, c2: the SSIM stabilisers; parts holds B*3*tm_ssim_blocks(h,w)*2
// floats, the only scratch.
int tm_ssim_level(const float* level, int batch, int h, int w, int quantize, const float* win,
                  float c1, float c2, int clo, int chi, float* parts, float* sums, int sums_bstride,
                  float* ds, void* stream) {
  if (h < kTaps || w < kTaps || clo < 0 || clo > chi || chi > w - 2 * kRadius) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = 3 * batch;
  const dim3 grid((w - 2 * kRadius + kTileW - 1) / kTileW, (h - 2 * kRadius + kTileH - 1) / kTileH,
                  planes);
  if (quantize) {
    ssim_tile_kernel<true><<<grid, kTileThreads, 0, s>>>(level, planes, h, w, clo, chi, win, c1, c2,
                                                          parts, ds);
  } else {
    ssim_tile_kernel<false><<<grid, kTileThreads, 0, s>>>(level, planes, h, w, clo, chi, win, c1, c2,
                                                           parts, ds);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<2><<<planes, kReduceThreads, 0, s>>>(parts, ssim_blocks(h, w), sums,
                                                           sums_bstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
