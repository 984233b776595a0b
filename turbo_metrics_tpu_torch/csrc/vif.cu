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
// over: here each sample is read at its reflect-101 index directly (ind < 0
// -> -ind, ind >= n -> 2n-ind-2, level.cuh reflect101).
//
// Numerics: every operation is written with an explicit rounding intrinsic
// (__fmul_rn, __fadd_rn, ...), so the compiler contracts nothing into FMAs
// and each blur, product and guard is the f32 value of the plain version's
// expression order (ops/vif.py); only the sums (f32 per tile, then f64)
// and log2f's last bit differ.  The s11 < EPS guard is discontinuous, so
// this keeps the kernel on the same side of it as the plain version.
//
// A scale is one launch of vif_tile_kernel<R, RE> (both blur passes, the
// map, the per-32x8-tile partials and the emission of the next scale), then
// the f64 reduction of the partials (level.cuh reduce_frames_kernel).
//
// Only a window [clo, chi) of the scale's columns adds to the sums (0 and w:
// all of them).  A column strip of a frame cut with a halo (parallel/mesh.py
// spatial_sharding; ops/kernels/vif.py) blurs and emits every column it
// holds but sums only the maps of the columns it owns.  A tile wholly
// outside the window skips its five-quantity passes and its map and writes
// zero partials, the bits its pass would write; it still emits its part of
// the next scale.
//
// What bounds it on this card: the f32 work.  Per pixel of the pair at scale
// 0 the algorithm needs 8 bytes in against ~390 f32 operations (five
// quantities, 17 taps, two passes; the map; the emission at a quarter of the
// pixels), and without FMAs each of them is an instruction: with the halo
// rows of the row pass about 460 per pixel.  What the design does about it,
// after level_tile_kernel (ssimulacra2_scale.cu):
//   * one block of 128 threads per 32x32 output tile of one frame; the
//     tile's input rows y0-R .. y0+31+R and columns x0-P .. x0+31+P (P: R
//     rounded up to a multiple of 4) of both images go to shared memory,
//     each row and column at its reflect-101 index: 16-byte loads where a
//     chunk lies inside the plane and is aligned, single loads at the
//     mirrored edges, all issued before the first store;
//   * the five row-blurred quantities over the 32+2R rows stay in shared
//     memory and never reach device memory; at R = 8 the tile takes 54,272
//     B of dynamic shared memory (inputs 18,432, row planes 30,720,
//     emission rows 5,120), so four blocks share an SM;
//   * register blocking in the column pass: each thread computes one column
//     of one 32x8 sub-tile, eight outputs from an (8+2R)-row window;
//   * each warp owns one 32x8 sub-tile, so level.cuh's fixed partial tree
//     runs in registers and warp shuffles, the same pairs in the same order
//     as tile_partials over a (32, 8) block;
//   * the emission (RE > 0) runs the next window's row pass of ref and dis
//     at the tile's 16 even columns over rows y0-RE .. y0+31+RE, which lie
//     inside the loaded tile (RE < R), then its column pass at the tile's
//     16 even rows, straight into the next scale's input.
//
// Layouts (all contiguous):
//   in     (2, B, h, w)          f32 luma in 8-bit units (reference, distorted)
//   parts  (B, nblk, 2)          f32 per-32x8-tile partial sums
//   sums   (B, ...)              f32 num, den at sums[b * sums_pstride + {0, 1}]
//   next   (2, B, ceil(h/2), ceil(w/2)) f32 the next scale's input

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"
#include "per_device.cuh"

namespace {

constexpr float kEps = 1e-10f;
constexpr float kSigmaNsq = 2.0f;

constexpr int kEmitW = kTileW / 2;         // the next scale's columns of a tile

// The shared-memory tile of a scale with a window of radius R and a next
// window of radius RE (0: no emission).
template <int R, int RE>
struct Tile {
  static constexpr int kInOff = (R + 3) / 4 * 4;          // input column 0 = output column -kInOff
  static constexpr int kInW = kTileW + 2 * kInOff;        // input columns held
  static constexpr int kHaloH = kTileH + 2 * R;           // input rows (y0-R .. y0+31+R)
  static constexpr int kInFloats = kHaloH * kInW;         // one image's input tile
  static constexpr int kRowFloats = kHaloH * kTileW;      // one row-blurred quantity
  static constexpr int kEmitH = RE > 0 ? kTileH + 2 * RE : 0;  // emission rows (y0-RE .. y0+31+RE)
  static constexpr int kEmitFloats = kEmitH * kEmitW;     // one image's emission rows
  static constexpr int kColWin = kBy + 2 * R;             // rows of a thread's column window
  static constexpr int kChunks = 2 * kInFloats / 4;
  static constexpr int kLoadsPerThread = (kChunks + kTileThreads - 1) / kTileThreads;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kInFloats + 5 * kRowFloats + 2 * kEmitFloats);
};

// One tap t (k-th of the window) of the row pass on the reference's sample
// av and the distorted image's dv: s accumulates ref, dis, ref^2, dis^2,
// ref*dis, the squares formed per tap.
__device__ __forceinline__ void vif_row_tap(float (&s)[5], int k, float t, float av, float dv) {
  const float x[5] = {av, dv, __fmul_rn(av, av), __fmul_rn(dv, dv), __fmul_rn(av, dv)};
#pragma unroll
  for (int q = 0; q < 5; ++q) s[q] = k == 0 ? __fmul_rn(t, x[q]) : __fadd_rn(s[q], __fmul_rn(t, x[q]));
}

// One tap t (k-th of the window) of the column pass on the five row sums x
// of one row.
__device__ __forceinline__ void vif_col_tap(float (&s)[5], int k, float t, const float (&x)[5]) {
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float m = __fmul_rn(t, x[q]);
    s[q] = k == 0 ? m : __fadd_rn(s[q], m);
  }
}

// The guarded map of one pixel (ops/vif.py scale_sums, in its order) from
// its five blurred quantities: v = (num, den).
__device__ __forceinline__ void vif_map(const float (&s)[5], float (&v)[2]) {
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

// Samples gc .. gc+3 of row gr of plane p, each at its reflect-101 index:
// one 16-byte load where the four lie inside the row and are 16-byte
// aligned (every interior chunk of a plane whose width is a multiple of 4),
// else one load each.
__device__ __forceinline__ float4 load4_reflect(const float* __restrict__ p, int h, int w, int gr,
                                                int gc) {
  const float* q = p + (size_t)reflect101(gr, h) * w;
  if (gc >= 0 && gc + 3 < w && reinterpret_cast<uintptr_t>(q + gc) % 16 == 0) {
    return __ldg(reinterpret_cast<const float4*>(q + gc));
  }
  return make_float4(__ldg(q + reflect101(gc, w)), __ldg(q + reflect101(gc + 1, w)),
                     __ldg(q + reflect101(gc + 2, w)), __ldg(q + reflect101(gc + 3, w)));
}

// ---------------------------------------------------------------------------
// One block per 32x32 output tile of frame blockIdx.z: the tile's input
// samples of both images into shared memory, the row pass of the five
// quantities (window radius R) into shared memory, the column pass and the
// map, and each 32x8 sub-tile's two partials into parts[(b * nblk + blk) *
// 2 + k], blk = its index in the frame's (ceil(h/8), ceil(w/32)) grid of
// 32x8 tiles (reduce_frames_kernel<2> then sums them in f64), only the
// maps of the columns [clo, chi) adding.  With RE > 0
// also the tile's 16x16 pixels of the next scale's input,
// decimate2(blur(x, next window)), into next.
// grid: (ceil(w/32), ceil(h/32), B), block: kTileThreads (1-D), dynamic
// shared memory: Tile<R, RE>::kSmemBytes.
// ---------------------------------------------------------------------------
template <int R, int RE>
__global__ void __launch_bounds__(kTileThreads, 4)
vif_tile_kernel(const float* __restrict__ src, int bsz, int h, int w, int clo, int chi,
                const float* __restrict__ win, const float* __restrict__ win_e, float* __restrict__ parts,
                float* __restrict__ next) {
  using T = Tile<R, RE>;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                         // [2 images][kHaloH][kInW]
  float* rows = in + 2 * T::kInFloats;      // [5 quantities][kHaloH][kTileW]
  float* emit = rows + 5 * T::kRowFloats;   // [2 images][kEmitH][kEmitW]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const int nbx = (w + kBx - 1) / kBx, nby = (h + kBy - 1) / kBy;
  const int by = blockIdx.y * kSubTiles + warp;  // this warp's sub-tile row in that grid
  const int c = x0 + lane;                       // this thread's output column
  // The whole block: the tile's 32 columns all lie outside the window.
  const bool outside = x0 + kTileW <= clo || x0 >= chi;
  float v[kBy / 2][2];
  if (outside && RE == 0) {
#pragma unroll
    for (int o = 0; o < kBy / 2; ++o) v[o][0] = v[o][1] = 0.0f;
    subtile_partials<2>(v, parts, b, blockIdx.x, by, nbx, nby);
    return;
  }

  // Input tiles: rows y0-R .. y0+31+R, columns x0-kInOff .. x0+31+kInOff.
  {
    const float* a = src + (size_t)b * npx;
    const float* d = src + ((size_t)bsz + b) * npx;
    float4 ld[T::kLoadsPerThread];
#pragma unroll
    for (int n = 0; n < T::kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;  // chunk: 4 floats of the two tiles
      const int img = i / (T::kInFloats / 4), rem = 4 * i - img * T::kInFloats;
      const int r = rem / T::kInW;
      ld[n] = i < T::kChunks
                  ? load4_reflect(img ? d : a, h, w, y0 - R + r, x0 - T::kInOff + rem - r * T::kInW)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int n = 0; n < T::kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;
      if (i < T::kChunks) reinterpret_cast<float4*>(in)[i] = ld[n];
    }
  }
  float t[2 * R + 1], te[2 * RE + 1];
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) t[k] = __ldg(win + k);
  if constexpr (RE > 0) {
#pragma unroll
    for (int k = 0; k <= 2 * RE; ++k) te[k] = __ldg(win_e + k);
  }
  __syncthreads();

  // Row pass: every input row of the tile, one output column per lane
  // (none outside the window).
  for (int r = warp; r < T::kHaloH && !outside; r += kSubTiles) {
    const float* p = in + r * T::kInW + lane + (T::kInOff - R);
    float s[5];
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) vif_row_tap(s, k, t[k], p[k], p[k + T::kInFloats]);
#pragma unroll
    for (int q = 0; q < 5; ++q) rows[(q * T::kHaloH + r) * kTileW + lane] = s[q];
  }
  // The next window's row pass of ref and dis at the tile's even columns
  // (x0 + 2m): lanes 0-15 the reference, 16-31 the distorted image.
  if constexpr (RE > 0) {
    for (int idx = threadIdx.x; idx < T::kEmitH * 2 * kEmitW; idx += kTileThreads) {
      const int r = idx / (2 * kEmitW), img = (idx / kEmitW) % 2, m = idx % kEmitW;
      const float* p = in + img * T::kInFloats + (r + R - RE) * T::kInW + T::kInOff + 2 * m - RE;
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k <= 2 * RE; ++k) {
        const float x = __fmul_rn(te[k], p[k]);
        e = k == 0 ? x : __fadd_rn(e, x);
      }
      emit[(img * T::kEmitH + r) * kEmitW + m] = e;
    }
  }
  __syncthreads();

  if (outside) {
#pragma unroll
    for (int o = 0; o < kBy / 2; ++o) v[o][0] = v[o][1] = 0.0f;
  } else {
    // Column pass: column `lane` of the warp's sub-tile, eight outputs from
    // one window of kColWin rows (tile row o + k is input row y0 + o - R +
    // k), each summed over k = 0..2R in order.
    float s[kBy][5];
#pragma unroll
    for (int i = 0; i < T::kColWin; ++i) {
      const float* rp = rows + (warp * kBy + i) * kTileW + lane;
      float x[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) x[q] = rp[q * T::kRowFloats];
#pragma unroll
      for (int o = 0; o < kBy; ++o) {
        if (i - o >= 0 && i - o <= 2 * R) vif_col_tap(s[o], i - o, t[i - o], x);
      }
    }

    // The map, rows o and o + 4 added (the first stride of level.cuh's
    // tree), then the rest of the sub-tile's tree.  chi <= w: an owned
    // column lies in the plane.
    const bool owned = c >= clo && c < chi;
#pragma unroll
    for (int o = 0; o < kBy / 2; ++o) {
      float va[2] = {0.0f, 0.0f}, vb[2] = {0.0f, 0.0f};
      const int ra = y0 + warp * kBy + o, rb = ra + kBy / 2;
      if (ra < h && owned) vif_map(s[o], va);
      if (rb < h && owned) vif_map(s[o + kBy / 2], vb);
#pragma unroll
      for (int k = 0; k < 2; ++k) v[o][k] = __fadd_rn(va[k], vb[k]);
    }
  }
  subtile_partials<2>(v, parts, b, blockIdx.x, by, nbx, nby);

  // The next window's column pass at the tile's even rows (y0 + 2i: emission
  // row 2i + k is input row y0 + 2i - RE + k): next scale pixel
  // (y0/2 + i, x0/2 + m) of both images.
  if constexpr (RE > 0) {
    const int he = (h + 1) / 2, we = (w + 1) / 2;
    for (int idx = threadIdx.x; idx < 2 * (kTileH / 2) * kEmitW; idx += kTileThreads) {
      const int img = idx / ((kTileH / 2) * kEmitW), i = (idx / kEmitW) % (kTileH / 2);
      const int m = idx % kEmitW;
      const int ni = y0 / 2 + i, nj = x0 / 2 + m;
      if (ni >= he || nj >= we) continue;
      const float* p = emit + (img * T::kEmitH + 2 * i) * kEmitW + m;
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k <= 2 * RE; ++k) {
        const float x = __fmul_rn(te[k], p[k * kEmitW]);
        e = k == 0 ? x : __fadd_rn(e, x);
      }
      next[(((size_t)img * bsz + b) * he + ni) * we + nj] = e;
    }
  }
}

int vif_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// Allows the instance its dynamic shared memory: once per device
// (per_device.cuh), before the first launch or occupancy query on it.
template <int R, int RE>
cudaError_t tile_setup() {
  static tm_setup::PerDevice<cudaError_t> setups;
  cudaError_t err = cudaSuccess;
  const cudaError_t* setup = setups.get(&err, [](int) {
    return cudaFuncSetAttribute(vif_tile_kernel<R, RE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Tile<R, RE>::kSmemBytes);
  });
  return setup != nullptr ? *setup : err;
}

template <int R, int RE>
int launch_scale(const float* in, int bsz, int h, int w, const float* win, const float* win_e, int clo,
                 int chi, float* parts, float* sums, int sums_pstride, float* next, cudaStream_t s) {
  cudaError_t err = tile_setup<R, RE>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, bsz);
  vif_tile_kernel<R, RE><<<grid, kTileThreads, Tile<R, RE>::kSmemBytes, s>>>(in, bsz, h, w, clo, chi, win,
                                                                            win_e, parts, next);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<2><<<bsz, kReduceThreads, 0, s>>>(parts, vif_blocks(h, w), sums, sums_pstride);
  return (int)cudaGetLastError();
}

template <int R, int RE>
int tile_attrs(int* out) {
  cudaError_t err = tile_setup<R, RE>();
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, vif_tile_kernel<R, RE>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vif_tile_kernel<R, RE>, kTileThreads,
                                                        Tile<R, RE>::kSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)Tile<R, RE>::kSmemBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// Number of 32x8-tile partials tm_vif_level writes per frame of an h x w
// scale: the caller sizes `parts` as B*nblk*2 floats.
int tm_vif_blocks(int h, int w) { return vif_blocks(h, w); }

// What vif_tile_kernel takes at VIF scale `scale` (0-3) on this card:
// out[0] registers per thread, out[1] dynamic shared memory per block in
// bytes, out[2] resident blocks per SM, out[3] local memory per thread in
// bytes (spills).
int tm_vif_tile_attrs(int scale, int* out) {
  switch (scale) {
    case 0: return tile_attrs<8, 4>(out);
    case 1: return tile_attrs<4, 2>(out);
    case 2: return tile_attrs<2, 1>(out);
    case 3: return tile_attrs<1, 0>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// VIF scale `scale` (0-3, window 2^(4-scale)+1 taps `win`) of the pair `in`
// (2, B, h, w) -> sums[b * sums_pstride + {0, 1}] = (num, den) over the
// columns [clo, chi) (0 <= clo <= chi <= w; 0 and w: the whole scale;
// clo == chi: zeros).  With scale
// < 3 it also writes `next` (2, B, ceil(h/2), ceil(w/2)) = decimate2(blur(in,
// win_e)), win_e the next scale's window (at scale 3 win_e and next are
// unused and may be null).  parts holds B*tm_vif_blocks(h, w)*2 floats, the
// only scratch.
int tm_vif_level(const float* in, int bsz, int h, int w, int scale, const float* win,
                 const float* win_e, int clo, int chi, float* parts, float* sums, int sums_pstride,
                 float* next, void* stream) {
  if (clo < 0 || clo > chi || chi > w) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 0: return launch_scale<8, 4>(in, bsz, h, w, win, win_e, clo, chi, parts, sums, sums_pstride, next, s);
    case 1: return launch_scale<4, 2>(in, bsz, h, w, win, win_e, clo, chi, parts, sums, sums_pstride, next, s);
    case 2: return launch_scale<2, 1>(in, bsz, h, w, win, win_e, clo, chi, parts, sums, sums_pstride, next, s);
    case 3: return launch_scale<1, 0>(in, bsz, h, w, win, win_e, clo, chi, parts, sums, sums_pstride, next, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
