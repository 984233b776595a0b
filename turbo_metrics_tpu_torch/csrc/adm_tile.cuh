// The tile geometry and the float finish of one ADM level, shared by the
// float kernel (adm.cu, #18) and the fixed-point one (integer_adm.cu), so
// that both decouple, weight, mask and pool the same way in the same order
// (ops/adm.py decouple_csf and level_sums):
//   * the tile: a block of kThreadsAdm threads owns a 32x32 tile of band
//     pixels of one frame plus the mask's one-pixel halo (kBand x kBand),
//     reads kInRows input rows and kRawW raw columns of each image, and
//     keeps the row pass (lo and hi) of both images in shared memory;
//   * decouple_csf: the decoupling ratio, the gate's choice and the CSF
//     weights of one band pixel;
//   * put_mask: the mask's products of one band pixel into shared memory;
//   * mask_cubes_partials: the 3x3 masks, the centre-region cubes and each
//     32x8 sub-tile's six partials.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr int kAdmTaps = 4;

// The finish's constants (ops/adm.py): CSF factors of the H/V and D bands,
// the decoupling epsilon, the mask filter weights 1/15 and 1/30.
struct AdmFinish {
  float rf_hv, rf_d;
  float eps;
  float m_centre, m_edge;
};

// The shared-memory tile: band pixels (li, lj) in [0, kBand)^2 are band
// (by0 - 1 + li, bx0 - 1 + lj) of a tile at (by0, bx0); input row lr in [0,
// kInRows) is input row symmetric(2 by0 - 3 + lr), and raw column k of it
// input column symmetric(A + k), A = 2 bx0 - 4 - 2 (bx0 & 1) (a multiple of
// 4, so that a raw row is whole 16-byte chunks).
constexpr int kThreadsAdm = 2 * kTileThreads;  // 8 warps, two per 32x8 sub-tile
constexpr int kBand = kTileW + 2;            // band pixels per side: the tile and the mask halo
constexpr int kInRows = 2 * kBand + 2;       // input rows a tile reads (band i reads 2i-1 .. 2i+2)
constexpr int kRawChunks = kBand / 2 + 2;    // 16-byte chunks of a raw row (19)
constexpr int kRawW = 4 * kRawChunks;        // raw samples of a row (76)
constexpr int kPairs = (kBand + 2) / 2;      // band-column pairs of the row pass (one spare)
constexpr int kRawStride = (kInRows * kRawW + 31) / 32 * 32;  // one image's raw rows, 128-byte aligned
constexpr int kRawFloats = 2 * kRawStride;     // both images' raw rows
constexpr int kRowFloats = kInRows * kBand;  // one row-filtered plane (lo or hi of one image)
constexpr int kBandFloats = kBand * kBand;   // one plane of band pixels
constexpr int kHalo = 4 * kBand - 4;         // band pixels of the halo ring
constexpr int kRowsPerWarp = kBy / 2;        // interior band rows of a warp
constexpr int kRowLanes = kPairs * (kThreadsAdm / kPairs);        // row-pass threads (252)

// Half-sample symmetric index of i on an axis of n (x[-1] = x[0], x[n] =
// x[n-1]), period 2n.
__device__ __forceinline__ int symmetric(int i, int n) {
  if (i >= 0 && i < n) return i;
  int m = i % (2 * n);
  if (m < 0) m += 2 * n;
  return m < n ? m : 2 * n - 1 - m;
}

// Raw column 0 of the tile at bx0: input column 2 bx0 - 4 - 2 (bx0 & 1), a
// multiple of 4.
__device__ __forceinline__ int raw_col0(int bx0) { return 2 * bx0 - 4 - 2 * (bx0 & 1); }

// The tile of t = (b ny + ty) nx + tx, of a grid anchored at the centre
// region's origin (top, left), starting at (gy0, gx0): frame b, band origin
// (by0, bx0).
__device__ __forceinline__ void tile_origin(int t, int nx, int ny, int gy0, int gx0, int& b, int& by0,
                                            int& bx0) {
  b = t / (nx * ny);
  by0 = gy0 + (t / nx % ny) * kTileH;
  bx0 = gx0 + t % nx * kTileW;
}

// Halo band pixel i of the ring (0 .. kHalo-1): its (li, lj) in the tile.
__device__ __forceinline__ void halo_pixel(int i, int& li, int& lj) {
  if (i < kBand) {
    li = 0, lj = i;
  } else if (i < 2 * kBand) {
    li = kBand - 1, lj = i - kBand;
  } else if (i < 2 * kBand + kTileH) {
    li = i - 2 * kBand + 1, lj = 0;
  } else {
    li = i - 2 * kBand - kTileH + 1, lj = kBand - 1;
  }
}

// What a band pixel gives the finish: |csf*a|, |csf*r|, |csf*o| of bands
// H, V, D.
struct BandPixel {
  float ca[3], cr[3], co[3];
};

// Decoupling and CSF of one band pixel from its detail bands o, t (H, V, D)
// under the gate angle_ok (ops/adm.py decouple_csf, in its order).
__device__ __forceinline__ BandPixel decouple_csf(const float (&o)[3], const float (&t)[3], bool angle_ok,
                                                  const AdmFinish& f) {
  BandPixel p;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float rf = q == 2 ? f.rf_d : f.rf_hv;
    const float k = fminf(fmaxf(__fdiv_rn(t[q], __fadd_rn(o[q], f.eps)), 0.0f), 1.0f);
    const float r = angle_ok ? t[q] : __fmul_rn(k, o[q]);
    p.ca[q] = fabsf(__fmul_rn(rf, __fsub_rn(t[q], r)));
    p.cr[q] = fabsf(__fmul_rn(rf, r));
    p.co[q] = fabsf(__fmul_rn(rf, o[q]));
  }
  return p;
}

// The mask's products |csf*a| * (1/30) into me and |csf*a| * (1/15) into mc
// ([H, V, D][kBand][kBand]) at band pixel (li, lj).
__device__ __forceinline__ void put_mask(float* __restrict__ me, float* __restrict__ mc, int li, int lj,
                                         const BandPixel& p, const AdmFinish& f) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    me[q * kBandFloats + li * kBand + lj] = __fmul_rn(p.ca[q], f.m_edge);
    mc[q * kBandFloats + li * kBand + lj] = __fmul_rn(p.ca[q], f.m_centre);
  }
}

// After every band pixel of the tile at (b, by0, bx0) has put its mask
// products (the caller syncs the block first): the mask (three 3x3 filters
// over |csf*a|, neighbours at their reflect-101 index in the plane, summed
// in the plain version's order) and the cubes at the centre region [top,
// ch-top) x [left, cw-left) of the warp's four rows (row0 .. row0+3 of the
// tile, column lane; cr, co their |csf*r| and |csf*o|), then each 32x8
// sub-tile's six partials into parts (the centre region's pixel_grid, nbx x
// nby blocks per frame).  The four rows of a thread share their neighbours:
// rows row0 - 1 .. row0 + 4 (reflected) of columns lane - 1 .. lane + 1 are
// read once.  A pixel of the plane finds them inside the tile's band
// pixels; one outside it (whose cubes are not summed) reads clamped
// indices.  xch: 4 * kRowsPerWarp * 6 * 32 floats of shared memory that
// nothing else reads now.  Every thread of the block calls it.
__device__ __forceinline__ void mask_cubes_partials(const float* __restrict__ me, const float* __restrict__ mc,
                                                    float* __restrict__ xch, const float (&cr)[kRowsPerWarp][3],
                                                    const float (&co)[kRowsPerWarp][3], int b, int by0, int bx0,
                                                    int row0, int ch, int cw, int top, int left, int nbx, int nby,
                                                    float* __restrict__ parts) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = warp / 2, half = warp % 2;
  const int gj = bx0 + lane;
  int nrow[kRowsPerWarp + 2], ncol[3];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp + 2; ++r) {
    nrow[r] = min(max(reflect101(by0 + row0 - 1 + r, ch) - by0 + 1, 0), kBand - 1) * kBand;
  }
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) ncol[dx] = min(max(reflect101(gj - 1 + dx, cw) - bx0 + 1, 0), kBand - 1);
  float thr[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float e[kRowsPerWarp + 2][3], cen[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp + 2; ++r) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) e[r][dx] = me[q * kBandFloats + nrow[r] + ncol[dx]];
    }
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o) cen[o] = mc[q * kBandFloats + nrow[o + 1] + ncol[1]];
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o) {
      float m = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float x = (dy == 1 && dx == 1) ? cen[o] : e[o + dy][dx];
          m = (dy == 0 && dx == 0) ? x : __fadd_rn(m, x);
        }
      }
      thr[o] = q == 0 ? m : __fadd_rn(thr[o], m);
    }
  }
  const bool col_in = gj >= left && gj < cw - left;
  float v[kRowsPerWarp][6];
#pragma unroll
  for (int o = 0; o < kRowsPerWarp; ++o) {
    const int gi = by0 + row0 + o;
    const bool in_region = col_in && gi >= top && gi < ch - top;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float rm = fmaxf(__fsub_rn(cr[o][q], thr[o]), 0.0f);
      const float oc = co[o][q];
      v[o][2 * q] = in_region ? __fmul_rn(__fmul_rn(rm, rm), rm) : 0.0f;
      v[o][2 * q + 1] = in_region ? __fmul_rn(__fmul_rn(oc, oc), oc) : 0.0f;
    }
  }
  // Rows o and o + 4 of each sub-tile added (the first stride of level.cuh's
  // tree) in the warp that holds rows 0-3, then the rest of the tree.
  float* x4 = xch + sub * (kRowsPerWarp * 6 * 32) + lane;
  if (half == 1) {
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o) {
#pragma unroll
      for (int k = 0; k < 6; ++k) x4[(o * 6 + k) * 32] = v[o][k];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o) {
#pragma unroll
      for (int k = 0; k < 6; ++k) v[o][k] = __fadd_rn(v[o][k], x4[(o * 6 + k) * 32]);
    }
    subtile_partials<6>(v, parts, b, (bx0 - left) / kBx, (by0 - top) / kBy + sub, nbx, nby);
  }
}

// Partial blocks per frame of a ch x cw band plane with centre region [top,
// ch-top) x [left, cw-left): its pixel_grid.
int adm_blocks(int ch, int cw, int top, int left) {
  const dim3 g = pixel_grid(ch - 2 * top, cw - 2 * left, 1);
  return (int)(g.x * g.y);
}

// The tile grid of a level with an h x w input: (gy0, gx0) its first tile's
// band origin, nx x ny tiles per frame.
struct AdmGrid {
  int gy0, gx0, nx, ny;
};

__host__ __device__ inline AdmGrid adm_grid(int h, int w, int top, int left) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int ky = (top + kTileH - 1) / kTileH, kx = (left + kTileW - 1) / kTileW;
  AdmGrid g;
  g.gy0 = top - ky * kTileH;
  g.gx0 = left - kx * kTileW;
  g.nx = (cw - g.gx0 + kTileW - 1) / kTileW;
  g.ny = (ch - g.gy0 + kTileH - 1) / kTileH;
  return g;
}

}  // namespace
