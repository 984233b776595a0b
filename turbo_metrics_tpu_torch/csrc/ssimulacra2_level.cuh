// The arithmetic of one SSIMULACRA2 pyramid level, shared by the per-level
// launches of ssimulacra2_scale.cu (kernels 1, 2, #3, #8, #10) and the
// persistent tail kernel of ssimulacra2_tail.cu (#4), so that every route
// computes the same values in the same order:
//   * cbrt_nr / to_xyb: linear RGB -> positive-shifted XYB (ops/xyb.py);
//   * rgb_quad: one 2x2 quad of a linear-RGB level -> XYB of its pixels and
//     the quad's mean, the next level's pixel;
//   * row_tap: one tap of the horizontal 11-tap pass of x1, x2, (x1-x2)^2,
//     x1*x2;
//   * col_tap: one tap of the vertical pass of those four row sums;
//   * ssim_maps: the SSIM, artifact and detail-loss maps of one pixel from
//     its four blurred quantities, and the six reduced quantities;
//   * level_tile: the fused level pass of one 32x32 output tile (both blur
//     passes over a shared-memory tile, the maps, the 32x8 partials), which
//     level_tile_kernel runs once per block and #4's blocks run tile after
//     tile.
#pragma once

#include <cuda_runtime.h>

#include "level.cuh"

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
// ops/downscale.py does.  S: how src is read (level.cuh Src).
template <Src S>
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
      const float v[3] = {load_as<S>(src + at), load_as<S>(src + npx + at), load_as<S>(src + 2 * npx + at)};
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

// ---------------------------------------------------------------------------
// The fused level pass of one tile.
// ---------------------------------------------------------------------------
constexpr int kHaloH = kTileH + 2 * kRadius;   // input rows of a tile
constexpr int kInOff = 8;                      // input column 0 = output column -8
constexpr int kInW = kTileW + 2 * kInOff;      // input columns held (-8 .. 39; -5 .. 36 used)
constexpr int kInFloats = kHaloH * kInW;       // one image's input tile
constexpr int kRowFloats = kHaloH * kTileW;    // one row-blurred quantity
constexpr int kColWin = kBy + 2 * kRadius;     // rows of a thread's column window
// Four-float loads per thread: all issued before the first is stored.
constexpr int kChunks = 2 * kInFloats / 4;
constexpr int kLoadsPerThread = (kChunks + kTileThreads - 1) / kTileThreads;

// The maps of output row o of this thread's column (zeros outside the
// plane); p: the reference's XYB sample of the pixel in the input tile.
__device__ __forceinline__ void tile_maps(const float (&s)[4], const float* p, bool inside,
                                          float (&v)[6]) {
  if (inside) {
    ssim_maps(s, p[0], p[kInFloats], v);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = 0.0f;
  }
}

// The shared memory of one tile: both images' input tiles, then the four
// row-blurred quantities.
constexpr int kTileSmemFloats = 2 * kInFloats + 4 * kRowFloats;

// The fused level pass of the 32x32 output tile (tx, ty) of plane `plane`
// (b*3 + ch), run by a block of kTileThreads threads (1-D) with smem: the
// tile's 42x48 input samples of both images into shared memory (zeros
// outside the plane), the row pass of x1, x2, (x1-x2)^2, x1*x2 over the 42
// input rows into shared memory, the column pass and the maps, and each 32x8
// sub-tile's six partials into parts[((b*3 + ch) * nblk + blk) * 6 + k], blk
// = its index in the level's (ceil(h/8), ceil(w/32)) grid of 32x8 tiles
// (level.cuh pixel_grid; reduce_plane<6> then sums them in f64).  Only the
// window of owned columns [clo, chi) (0 <= clo < chi <= w; 0 and w for the
// whole plane) adds to the partials: a column strip of a frame cut with a
// halo (parallel/mesh.py spatial_sharding) blurs its halo columns but sums
// only its own.  A tile that lies wholly outside the window skips its pass
// and writes zero partials, the bits its pass would write.  S: how the XYB
// planes are read (level.cuh Src).  A caller that runs another tile in the
// same block syncs the block first.
template <Src S>
__device__ __forceinline__ void level_tile(const float* __restrict__ xa,
                                           const float* __restrict__ xb, int h, int w, int clo,
                                           int chi, const float* __restrict__ taps,
                                           float* __restrict__ parts, int tx, int ty,
                                           size_t plane, float* __restrict__ smem) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* in = smem;                     // [2 images][kHaloH][kInW]
  float* rows = smem + 2 * kInFloats;  // [4 quantities][kHaloH][kTileW]
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const size_t npx = (size_t)h * w;
  const int nbx = (w + kBx - 1) / kBx, nby = (h + kBy - 1) / kBy;
  const int by = ty * kSubTiles + warp;  // this warp's sub-tile row in that grid
  const int c = x0 + lane;                       // this thread's output column
  if (x0 + kTileW <= clo || x0 >= chi) {  // the whole block: tx is the block's
    if (lane == 0 && by < nby) {
      float* out = parts + (plane * nbx * nby + (size_t)by * nbx + tx) * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) out[k] = 0.0f;
    }
    return;
  }

  // Input tiles: rows y0-5 .. y0+36, columns x0-8 .. x0+39 of both planes.
  {
    const float* a = xa + plane * npx;
    const float* b = xb + plane * npx;
    float4 ld[kLoadsPerThread];
#pragma unroll
    for (int n = 0; n < kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;  // chunk: 4 floats of the two tiles
      const int img = i / (kInFloats / 4), rem = 4 * i - img * kInFloats;
      const int r = rem / kInW;
      ld[n] = i < kChunks ? load4<S>(img ? b : a, h, w, y0 - kRadius + r, x0 - kInOff + rem - r * kInW)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int n = 0; n < kLoadsPerThread; ++n) {
      const int i = threadIdx.x + n * kTileThreads;
      if (i < kChunks) reinterpret_cast<float4*>(in)[i] = ld[n];
    }
  }
  float t[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) t[k] = __ldg(taps + k);
  __syncthreads();

  // Row pass: every input row of the tile, one output column per lane.
  for (int r = warp; r < kHaloH; r += kSubTiles) {
    const float* p = in + r * kInW + lane + (kInOff - kRadius);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) row_tap(s, t[k], p[k], p[k + kInFloats]);
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[(q * kHaloH + r) * kTileW + lane] = s[q];
  }
  __syncthreads();

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
      if (i - o >= 0 && i - o < kTaps) col_tap(s[o], t[i - o], x);
    }
  }

  // The maps, rows o and o + 4 added (the first stride of level.cuh's tree),
  // then the rest of the sub-tile's tree.
  float v[kBy / 2][6];
#pragma unroll
  for (int o = 0; o < kBy / 2; ++o) {
    float va[6], vb[6];
    const int ra = warp * kBy + o, rb = ra + kBy / 2;
    const float* p = in + (ra + kRadius) * kInW + lane + kInOff;
    const bool owned = c >= clo && c < chi;
    tile_maps(s[o], p, y0 + ra < h && owned, va);
    tile_maps(s[o + kBy / 2], p + (kBy / 2) * kInW, y0 + rb < h && owned, vb);
#pragma unroll
    for (int k = 0; k < 6; ++k) v[o][k] = __fadd_rn(va[k], vb[k]);
  }
  subtile_partials<6>(v, parts, plane, tx, by, nbx, nby);
}


}  // namespace
