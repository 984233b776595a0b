// The tile geometry, the raw-row copies and the float finish of one ADM
// level, shared by the float kernel (adm.cu, #18) and the fixed-point one
// (integer_adm.cu), so that both read, decouple, weight, mask and pool the
// same way in the same order (ops/adm.py decouple_csf and level_sums):
//   * the tile: a block of kThreadsAdm threads owns a 32x32 tile of band
//     pixels of one frame plus the mask's one-pixel halo (kBand x kBand),
//     reads kInRows input rows and kRawW raw columns of each image, and
//     keeps the row pass (lo and hi) of both images in shared memory;
//   * the raw rows (RawTile<E>, at the input's own type E): copied by the
//     Tensor Memory Accelerator (start_raw, completing on an mbarrier,
//     then fix_edges), or loaded by the block (load_raw) where the tensor
//     copy does not take the input (raw_tensor_map);
//   * decouple_csf: the decoupling ratio, the gate's choice and the CSF
//     weights of one band pixel;
//   * put_mask: |csf*a| of one band pixel into shared memory;
//   * mask_cubes_partials: the 3x3 masks (the products |csf*a| * 1/30 and
//     * 1/15 formed where they are read), the cubes of the summed window and
//     each 32x8 sub-tile's six partials.
// The summed window is the centre region's rows [top, ch-top) and a range
// of band columns [clo, chi): the centre's [left, cw-left) for a whole
// frame, or a column strip's owned part of the frame's centre
// (ops/adm.py level_windows).  The tile grid is
// anchored at (top, clo).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kRowFloats = kInRows * kBand;  // one row-filtered plane (lo or hi of one image)
constexpr int kBandFloats = kBand * kBand;   // one plane of band pixels
constexpr int kHalo = 4 * kBand - 4;         // band pixels of the halo ring
constexpr int kRowsPerWarp = kBy / 2;        // interior band rows of a warp
constexpr int kRowLanes = kPairs * (kThreadsAdm / kPairs);        // row-pass threads (252)

// The raw rows of a tile at element type E in shared memory: kInRows rows of
// kW samples per image, each image's rows 128-byte aligned.  A row is the
// box row of a tensor copy that starts at the 16-byte boundary at or before
// the tile's raw column 0 (raw_off samples before it) and holds its kRawW
// samples, in whole 16-byte chunks: 76 samples at f32 and int32 (raw
// column 0 is a multiple of 4, so the offset is 0), 80 at uint16, 96 at
// uint8.
template <typename E>
struct RawTile {
  static constexpr int kAlign = 16 / (int)sizeof(E);          // samples of 16 bytes
  static constexpr int kMaxOff = kAlign > 4 ? kAlign - 4 : 0;  // the largest raw_off
  static constexpr int kW = (kRawW + kMaxOff + kAlign - 1) / kAlign * kAlign;
  static constexpr int kStride = (kInRows * kW * (int)sizeof(E) + 127) / 128 * 128 / (int)sizeof(E);
  static constexpr int kBytes = 2 * kStride * (int)sizeof(E);
};

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

// Where raw column k of the tile at bx0 lies in its shared row: at raw_off
// + k, raw_off the distance from the 16-byte boundary at or before raw
// column 0 (where the tensor copy's box starts); 0 at f32 and int32.
template <typename E>
__device__ __forceinline__ int raw_off(int bx0) {
  constexpr int a = RawTile<E>::kAlign;
  return ((raw_col0(bx0) % a) + a) % a;
}

// The Tensor Memory Accelerator's copy of one image's raw rows: the box of
// kW x kInRows samples at column c0, row c1 of plane c2 of the input
// (tmap), zeros outside the input, completing on the mbarrier at bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& tmap, int c0, int c1, int c2,
                                         unsigned bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(d),
      "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Thread 0: the mbarrier at bar initialised for one arrival; the block
// syncs before it is used.
__device__ __forceinline__ void init_barrier(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the mbarrier at bar has completed the phase of this parity.
__device__ __forceinline__ void wait_parity(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Thread 0 starts the copy of both images' raw rows of the tile at (b, by0,
// bx0) into raw[image][lr][kW], from the 16-byte boundary at or before raw
// column 0; the block waits for the mbarrier's phase (wait_parity), then
// fills the samples outside the input (fix_edges).
template <typename E>
__device__ __forceinline__ void start_raw(E* __restrict__ raw, const CUtensorMap& tmap, int bsz, int b, int by0,
                                          int bx0, unsigned bar) {
  using RT = RawTile<E>;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"((int)(2 * kInRows * RT::kW * sizeof(E)))
               : "memory");
#pragma unroll
  for (int im = 0; im < 2; ++im) {
    tma_load(raw + im * RT::kStride, tmap, raw_col0(bx0) - raw_off<E>(bx0), 2 * by0 - 3, im * bsz + b, bar);
  }
}

// Where the box left the h x w input, the samples that a band pixel of the
// plane reads get the value at their symmetric index, which the box holds
// (h >= 4, w >= 8): input rows -1, h and h+1 (every column of the box that
// is read, -1 .. w+2), then columns -1, w, w+1 and w+2 of the other rows.
template <typename E>
__device__ __forceinline__ void fix_edges(E* __restrict__ raw, int h, int w, int by0, int bx0) {
  using RT = RawTile<E>;
  const int r0 = 2 * by0 - 3, a0 = raw_col0(bx0), off = raw_off<E>(bx0);
  if (r0 >= 0 && r0 + kInRows <= h && a0 >= 0 && a0 + kRawW <= w) return;
  constexpr int kRowFix = 3 * kRawW, kColFix = 4 * kInRows;
  for (int i = threadIdx.x; i < 2 * (kRowFix + kColFix); i += kThreadsAdm) {
    const int im = i / (kRowFix + kColFix), n = i % (kRowFix + kColFix);
    int r, col;
    if (n < kRowFix) {
      const int e = n / kRawW;
      r = e == 0 ? -1 : h - 1 + e;
      col = a0 + n % kRawW;
    } else {
      const int e = (n - kRowFix) / kInRows;
      r = r0 + (n - kRowFix) % kInRows;
      col = e == 0 ? -1 : w - 1 + e;
      if (r < 0 || r >= h) continue;
    }
    const int lr = r - r0, k = col - a0;
    if (lr < 0 || lr >= kInRows || k < 0 || k >= kRawW || col < -1 || col > w + 2) continue;
    E* p = raw + im * RT::kStride + off;
    p[lr * RT::kW + k] = p[(symmetric(r, h) - r0) * RT::kW + symmetric(col, w) - a0];
  }
}

// The raw rows of the tile at (b, by0, bx0), by the whole block, at the
// places the tensor copy puts them: for inputs that the tensor copy does not
// take.  A warp per row (at its symmetric index), a lane per sample (the
// column's symmetric index only where the tile's columns leave the input);
// a thread issues the loads of kGroup rows before it stores the first.
template <typename E>
__device__ __forceinline__ void load_raw(E* __restrict__ raw, const E* __restrict__ in, int bsz, int b, int h,
                                         int w, int by0, int bx0) {
  using RT = RawTile<E>;
  constexpr int kWarps = kThreadsAdm / 32, kPerRow = (kRawW + 31) / 32, kGroup = 6;
  const int r0 = 2 * by0 - 3, a0 = raw_col0(bx0), off = raw_off<E>(bx0);
  const bool cols_in = a0 >= 0 && a0 + kRawW <= w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t npx = (size_t)h * w;
  for (int g = warp; g < 2 * kInRows; g += kGroup * kWarps) {
    E v[kGroup][kPerRow];
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
      const int rr = g + n * kWarps, im = rr >= kInRows, lr = rr - im * kInRows;
      const E* q = in + ((size_t)im * bsz + b) * npx + (size_t)symmetric(r0 + lr, h) * w;
#pragma unroll
      for (int j = 0; j < kPerRow; ++j) {
        const int k = lane + 32 * j;
        if (rr < 2 * kInRows && k < kRawW) v[n][j] = __ldg(q + (cols_in ? a0 + k : symmetric(a0 + k, w)));
      }
    }
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
      const int rr = g + n * kWarps, im = rr >= kInRows, lr = rr - im * kInRows;
#pragma unroll
      for (int j = 0; j < kPerRow; ++j) {
        const int k = lane + 32 * j;
        if (rr < 2 * kInRows && k < kRawW) raw[im * RT::kStride + lr * RT::kW + off + k] = v[n][j];
      }
    }
  }
}

// The tile of t = (b ny + ty) nx + tx, of a grid anchored at the summed
// window's origin (top, clo), starting at (gy0, gx0): frame b, band origin
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

// |csf*a| of band pixel (li, lj) into ca ([H, V, D][kBand][kBand]).
__device__ __forceinline__ void put_mask(float* __restrict__ ca, int li, int lj, const BandPixel& p) {
#pragma unroll
  for (int q = 0; q < 3; ++q) ca[q * kBandFloats + li * kBand + lj] = p.ca[q];
}

// After every band pixel of the tile at (b, by0, bx0) has put its |csf*a|
// (the caller syncs the block first): the mask (three 3x3 filters over
// |csf*a|, each neighbour's product with its weight, |csf*a| * (1/30) or at
// the centre * (1/15), formed as it is read, at its reflect-101 index in the
// plane, summed in the plain version's order) and the cubes at the summed
// window [top, ch-top) x [clo, chi) of the warp's four rows (row0 .. row0+3
// of the tile, column lane; cr, co their |csf*r| and |csf*o|), then each
// 32x8 sub-tile's six partials into parts (the window's pixel_grid, nbx x
// nby blocks per frame).  The four rows of a thread share their neighbours:
// rows row0 - 1 .. row0 + 4 (reflected) of columns lane - 1 .. lane + 1 are
// read once.  A pixel of the plane finds them inside the tile's band
// pixels; one outside it (whose cubes are not summed) reads clamped
// indices.  xch: 4 * kRowsPerWarp * 6 * 32 floats of shared memory that
// nothing else reads now.  Every thread of the block calls it.
__device__ __forceinline__ void mask_cubes_partials(const float* __restrict__ ca, float* __restrict__ xch,
                                                    const float (&cr)[kRowsPerWarp][3],
                                                    const float (&co)[kRowsPerWarp][3], int b, int by0, int bx0,
                                                    int row0, int ch, int cw, int top, int clo, int chi, int nbx,
                                                    int nby, const AdmFinish& f, float* __restrict__ parts) {
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
      for (int dx = 0; dx < 3; ++dx) e[r][dx] = __fmul_rn(ca[q * kBandFloats + nrow[r] + ncol[dx]], f.m_edge);
    }
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o) cen[o] = __fmul_rn(ca[q * kBandFloats + nrow[o + 1] + ncol[1]], f.m_centre);
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
  const bool col_in = gj >= clo && gj < chi;
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
    subtile_partials<6>(v, parts, b, (bx0 - clo) / kBx, (by0 - top) / kBy + sub, nbx, nby);
  }
}

// Partial blocks per frame of a band plane of ch rows whose window [top,
// ch-top) x [clo, chi) is summed: its pixel_grid (none for clo == chi).
int adm_blocks(int ch, int top, int clo, int chi) {
  const dim3 g = pixel_grid(ch - 2 * top, chi - clo, 1);
  return (int)(g.x * g.y);
}

// The tile grid of a level with an h x w input: (gy0, gx0) its first tile's
// band origin, nx x ny tiles per frame.
struct AdmGrid {
  int gy0, gx0, nx, ny;
};

// The grid is anchored at (top, clo) and extended by whole tiles until it
// covers the ch x cw band plane.
__host__ __device__ inline AdmGrid adm_grid(int h, int w, int top, int clo) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int ky = (top + kTileH - 1) / kTileH, kx = (clo + kTileW - 1) / kTileW;
  AdmGrid g;
  g.gy0 = top - ky * kTileH;
  g.gx0 = clo - kx * kTileW;
  g.nx = (cw - g.gx0 + kTileW - 1) / kTileW;
  g.ny = (ch - g.gy0 + kTileH - 1) / kTileH;
  return g;
}

// cuTensorMapEncodeTiled through the runtime's entry-point query (no link
// to libcuda): once per process.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of the (2B, h, w) input of element type E whose boxes are a
// tile's raw rows of one image (RawTile<E>::kW x kInRows); false where the
// tensor copy does not take the input (rows not a multiple of 16 bytes, an
// unaligned base, a plane smaller than 8 x 4): the kernel then loads the
// samples itself (load_raw).
template <typename E>
bool raw_tensor_map(CUtensorMap* map, const E* in, int bsz, int h, int w) {
  if ((w * sizeof(E)) % 16 != 0 || w < 8 || h < 4 || reinterpret_cast<uintptr_t>(in) % 16 != 0) return false;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = std::is_same_v<E, float>      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same_v<E, int>      ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                   : std::is_same_v<E, uint16_t> ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)2 * bsz};
  const cuuint64_t strides[2] = {(cuuint64_t)w * sizeof(E), (cuuint64_t)h * w * sizeof(E)};
  const cuuint32_t box[3] = {RawTile<E>::kW, kInRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<E*>(in), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
