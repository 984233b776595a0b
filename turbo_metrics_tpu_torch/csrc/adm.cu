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
// outputs; the mask filter reflects 101 (level.cuh reflect101).  The tile
// geometry and the finish (decoupling, CSF, masks, cubes and partials) are
// adm_tile.cuh's, shared with the fixed-point ADM (integer_adm.cu).
//
// Numerics: every operation is written with an explicit rounding intrinsic,
// so nothing is contracted into FMAs and every band, gate and masked value
// is the f32 value of the plain version's expression order (ops/adm.py).
// The angle gate (dot >= 0 and dot^2 >= cos^2(1 deg) |o|^2 |t|^2) is
// discontinuous; evaluated in the same order it flips no pixel against the
// plain version.  The cube sums span many magnitudes: f32 per 32x8 block in
// level.cuh's fixed tree, then f64 (reduce_frames_kernel).
//
// What bounds it on this card: device-memory traffic by the algorithm (per
// pixel of the pair at level 0, 8 bytes in and 2 out against ~63 f32
// operations), in practice the latency of each tile's dependent chains.  A
// level is one launch of adm_tile_kernel, then the f64 reduction of its
// partials:
//   * a persistent block of 8 warps (2 per SM) walks 32x32 tiles of band
//     pixels of one frame, both images (the angle gate needs o and t
//     together); the tile grid is anchored at the summed window's origin
//     (top, clo) and extended by whole tiles until it covers the ch x cw
//     band plane, so each 32x8 sub-tile is one block of the window's
//     pixel_grid and its partials are the ones a per-pixel design writes,
//     bit for bit;
//   * a tile reads 70 input rows x 76 columns of each image (band pixels
//     -1 .. 32 of the tile: the mask's one-pixel halo).  Thread 0 starts
//     the next tile's two boxes with the Tensor Memory Accelerator (one
//     tensor copy per image, completing on an mbarrier) as soon as the
//     current tile's row pass has read its own, so the copy runs under the
//     column pass and the mask; samples that fall outside the input are
//     then set from their symmetric index inside the box.  Copies issued
//     by the compute warps themselves (16-byte cp.async) stalled them for
//     as long as the copy took;
//   * the row pass (lo and hi at the tile's 34 band columns) goes to shared
//     memory; the column pass runs over four consecutive band rows per
//     thread, reading each of their 10 row-filtered rows once; the gate,
//     decoupling and CSF follow; |csf*a| goes to shared memory once per
//     band pixel (the mask forms its products as it reads it), |csf*r| and
//     |csf*o| of the interior stay in registers, and the A bands (the next
//     level's input) are written from the interior only;
//   * the mask reads its neighbours at their reflect-101 index in the plane,
//     which lies inside the tile's 34x34 band pixels wherever a mask halo
//     leaves the plane, so no band pixel is computed twice; a thread's four
//     rows share their neighbour rows.
// 94,720 B of dynamic shared memory per block (raw boxes 42,752, row
// passes 38,080, |csf*a| 13,872, the mbarrier), set once per process.
// Neither the row-filtered nor the band planes reach device memory.  An
// input whose rows are not whole 16-byte chunks, or smaller than 8 x 4, is
// loaded by the block's warps (adm_tile.cuh load_raw) instead of by tensor
// copies.
//
// The summed window: the centre region's rows [top, ch-top) and the band
// columns [clo, chi): the centre's [left, cw-left) for a whole frame, or, in
// a column strip of a frame cut with a halo (parallel/mesh.py
// spatial_sharding; ops/kernels/adm.py), the strip's owned part of the
// frame's centre columns.  Every tile of the plane still writes its A bands.
//
// Layouts (all contiguous; ch = ceil(h/2), cw = ceil(w/2)):
//   in     (2, B, h, w)      f32 luma in 8-bit units, or the previous level's A bands
//   approx (2, B, ch, cw)    f32 the A bands of ref and dis (the next level's input)
//   parts  (B, nblk, 6)      f32 per-32x8-block partial cube sums of the summed window
//   sums   (B, ...)          f32 at sums[b * sums_pstride + band * 2 + {0 num, 1 den}]

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adm_tile.cuh"
#include "per_device.cuh"

namespace {

constexpr int kTaps = kAdmTaps;

struct AdmConsts {
  float lo[kTaps], hi[kTaps];  // db2 analysis taps
  float cos1;                  // cos^2(1 deg)
  AdmFinish f;                 // the finish's constants
};

using Raw = RawTile<float>;
static_assert(Raw::kMaxOff == 0, "f32 raw rows start at raw column 0");
constexpr size_t kSmemBytes = Raw::kBytes + sizeof(float) * (4 * kRowFloats + 3 * kBandFloats) + 16;

// taps . x[k], as acc = x0*t0; acc = acc + xk*tk (the plain version's order).
template <typename Load>
__device__ __forceinline__ float dec(const float (&taps)[kTaps], Load load) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float x = __fmul_rn(load(k), taps[k]);
    acc = k == 0 ? x : __fadd_rn(acc, x);
  }
  return acc;
}

// One tap of the column pass: acc = x*t at k = 0, else acc + x*t (the
// plain version's order).
__device__ __forceinline__ void col_tap(float& acc, int k, float t, float x) {
  const float m = __fmul_rn(x, t);
  acc = k == 0 ? m : __fadd_rn(acc, m);
}

// The angle gate, decoupling and CSF of one band pixel from its A, H, V, D
// of both images, dwt[image][A, H, V, D] (ops/adm.py decouple, in its
// order).
__device__ __forceinline__ BandPixel gate_csf(const float (&dwt)[2][4], const AdmConsts& c) {
  const float o_h = dwt[0][1], o_v = dwt[0][2], t_h = dwt[1][1], t_v = dwt[1][2];
  const float ot_dp = __fadd_rn(__fmul_rn(o_h, t_h), __fmul_rn(o_v, t_v));
  const float o_mag_sq = __fadd_rn(__fmul_rn(o_h, o_h), __fmul_rn(o_v, o_v));
  const float t_mag_sq = __fadd_rn(__fmul_rn(t_h, t_h), __fmul_rn(t_v, t_v));
  const bool angle_ok =
      ot_dp >= 0.0f && __fmul_rn(ot_dp, ot_dp) >= __fmul_rn(__fmul_rn(c.cos1, o_mag_sq), t_mag_sq);
  const float o[3] = {dwt[0][1], dwt[0][2], dwt[0][3]}, t[3] = {dwt[1][1], dwt[1][2], dwt[1][3]};
  return decouple_csf(o, t, angle_ok, c.f);
}

// The column pass at kOut band pixels li0 .. li0+kOut-1 of column lj from
// the row-filtered planes rows[image][lo, hi][lr][lj] (A = lo taps on lo
// rows, H = lo on hi, V = hi on lo, D = hi on hi; ops/adm.py dwt_level):
// input rows 2 li0 .. 2 li0 + 2 kOut + 1 are read once each, every output
// summing its four taps in order.
template <int kOut>
__device__ __forceinline__ void column_pass(const float* __restrict__ rows, int li0, int lj,
                                            const AdmConsts& c, float (&dwt)[kOut][2][4]) {
  const float* base = rows + 2 * li0 * kBand + lj;
#pragma unroll
  for (int r = 0; r < 2 * kOut + 2; ++r) {
    float x[2][2];  // [image][lo, hi]
#pragma unroll
    for (int im = 0; im < 2; ++im) {
      x[im][0] = base[(2 * im) * kRowFloats + r * kBand];
      x[im][1] = base[(2 * im + 1) * kRowFloats + r * kBand];
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int k = r - 2 * o;
      if (k >= 0 && k < kTaps) {
#pragma unroll
        for (int im = 0; im < 2; ++im) {
          col_tap(dwt[o][im][0], k, c.lo[k], x[im][0]);
          col_tap(dwt[o][im][1], k, c.lo[k], x[im][1]);
          col_tap(dwt[o][im][2], k, c.hi[k], x[im][0]);
          col_tap(dwt[o][im][3], k, c.hi[k], x[im][1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// A persistent block of 8 warps walks the 32x32 tiles of band pixels t =
// blockIdx.x, blockIdx.x + gridDim.x, ... (tile (tx, ty) of frame b, t = (b
// ny + ty) nx + tx); the tile grid is anchored at (top, clo) and starts at
// (gy0, gx0) = (top - 32 ky, clo - 32 kx), ky = ceil(top/32), kx =
// ceil(clo/32).  Per tile: the raw rows (tensor copies when use_tma, tmap
// the input's map, else loads), the row pass into shared memory, the copy
// of the next tile's raw rows started, the column pass, gate, decoupling and
// CSF at the tile and its halo, the mask and the cubes at the summed
// window's pixels, and each 32x8 sub-tile's six partials into parts[(b *
// nblk + blk) * 6 + k], blk its index in the window's pixel_grid
// (reduce_frames_kernel<6> then sums them in f64); with approx non-null also
// the tile's A bands.  Warps 2s and 2s + 1 hold rows 0-3 and 4-7 of sub-tile
// s, one column per lane.
// grid: (min(tiles, resident blocks)), block: kThreadsAdm (1-D), dynamic
// shared memory: kSmemBytes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreadsAdm, 2)
adm_tile_kernel(const float* __restrict__ in, const __grid_constant__ CUtensorMap tmap, int use_tma,
                int bsz, int h, int w, int top, int clo, int chi, AdmConsts c, float* __restrict__ approx,
                float* __restrict__ parts) {
  extern __shared__ __align__(128) float smem[];
  float* raw = smem;                   // [2 images][Raw::kStride]: kInRows x Raw::kW each
  float* rows = raw + 2 * Raw::kStride;  // [2 images][lo, hi][kInRows][kBand]
  float* ca = rows + 4 * kRowFloats;   // [H, V, D][kBand][kBand] |csf*a|
  float* xch = rows;                   // rows 4-7 of each sub-tile's cubes, once rows is dead
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(ca + 3 * kBandFloats));
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const AdmGrid g = adm_grid(h, w, top, clo);
  const int ntiles = g.nx * g.ny * bsz;
  const int nbx = (chi - clo + kBx - 1) / kBx, nby = (ch - 2 * top + kBy - 1) / kBy;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = warp / 2, half = warp % 2;  // sub-tile, rows 0-3 or 4-7 of it
  auto origin = [&](int t, int& b, int& by0, int& bx0) {
    tile_origin(t, g.nx, g.ny, g.gy0, g.gx0, b, by0, bx0);
  };

  if (threadIdx.x == 0) init_barrier(bar);
  __syncthreads();
  if (use_tma && threadIdx.x == 0 && (int)blockIdx.x < ntiles) {
    int b, by0, bx0;
    origin(blockIdx.x, b, by0, bx0);
    start_raw(raw, tmap, bsz, b, by0, bx0, bar);
  }
  int parity = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int b, by0, bx0;
    origin(t, b, by0, bx0);
    if (use_tma) {
      wait_parity(bar, parity);
      parity ^= 1;
      fix_edges(raw, h, w, by0, bx0);
    } else {
      load_raw(raw, in, bsz, b, h, w, by0, bx0);
    }
    __syncthreads();

    // Row pass: thread i filters pair m = i % 18 of raw rows i / 18, + 14,
    // ...: band columns lj0 and lj0 + 1, lj0 = 2m - (bx0 & 1), from raw
    // samples 4m+1 .. 4m+6 (input columns s .. s+5, s = 2 bx0 - 3 + 2 lj0).
    if (threadIdx.x < kRowLanes) {
      const int m = threadIdx.x % kPairs;
      for (int rr = threadIdx.x / kPairs; rr < 2 * kInRows; rr += kRowLanes / kPairs) {
        const int im = rr >= kInRows, lr = rr - im * kInRows;
        const float* r = raw + im * Raw::kStride + lr * Raw::kW + 4 * m;
        const float4 p0 = *reinterpret_cast<const float4*>(r);
        const float4 p1 = *reinterpret_cast<const float4*>(r + 4);
        const float x[6] = {p0.y, p0.z, p0.w, p1.x, p1.y, p1.z};
        float* lo = rows + (2 * im) * kRowFloats + lr * kBand;
        float* hi = lo + kRowFloats;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lj = 2 * m - (bx0 & 1) + e;
          if (lj >= 0 && lj < kBand) {
            auto load = [&x, e](int k) { return x[2 * e + k]; };
            lo[lj] = dec(c.lo, load);
            hi[lj] = dec(c.hi, load);
          }
        }
      }
    }
    __syncthreads();
    // The next tile's raw rows come in while this one computes.
    if (use_tma && threadIdx.x == 0 && t + (int)gridDim.x < ntiles) {
      int nb, nby0, nbx0;
      origin(t + gridDim.x, nb, nby0, nbx0);
      start_raw(raw, tmap, bsz, nb, nby0, nbx0, bar);
    }

    // Column pass, gate, decoupling and CSF.  |csf*a| of each band pixel
    // goes to shared memory, once: first at the halo ring, ...
    for (int i = threadIdx.x; i < kHalo; i += kThreadsAdm) {
      int li, lj;
      halo_pixel(i, li, lj);
      float dwt[1][2][4];
      column_pass<1>(rows, li, lj, c, dwt);
      put_mask(ca, li, lj, gate_csf(dwt[0], c));
    }
    // ... then at the interior: column lane, the warp's four rows; |csf*r|
    // and |csf*o| stay in registers.
    const int gj = bx0 + lane;
    const int row0 = sub * kBy + half * kRowsPerWarp;  // the warp's first row in the tile
    float cr[kRowsPerWarp][3], co[kRowsPerWarp][3];
    {
      float dwt[kRowsPerWarp][2][4];
      column_pass<kRowsPerWarp>(rows, 1 + row0, lane + 1, c, dwt);
#pragma unroll
      for (int o = 0; o < kRowsPerWarp; ++o) {
        const int gi = by0 + row0 + o;
        const BandPixel p = gate_csf(dwt[o], c);
        put_mask(ca, 1 + row0 + o, lane + 1, p);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          cr[o][q] = p.cr[q];
          co[o][q] = p.co[q];
        }
        if (approx != nullptr && gi >= 0 && gi < ch && gj >= 0 && gj < cw) {
          const size_t nb = (size_t)ch * cw, at = (size_t)gi * cw + gj;
          approx[(size_t)b * nb + at] = dwt[o][0][0];
          approx[((size_t)bsz + b) * nb + at] = dwt[o][1][0];
        }
      }
    }
    __syncthreads();

    // The mask and the cubes at the summed window, then the partials.
    mask_cubes_partials(ca, xch, cr, co, b, by0, bx0, row0, ch, cw, top, clo, chi, nbx, nby, c.f, parts);
  }
}

// Allows the kernel its dynamic shared memory and reads how many of its
// blocks the card holds at once: once per device (per_device.cuh), before
// the first launch or occupancy query on it.
struct TileSetup {
  cudaError_t err;
  int per_sm, sms;
};

TileSetup tile_setup() {
  static tm_setup::PerDevice<TileSetup> setups;
  cudaError_t err = cudaSuccess;
  const TileSetup* setup = setups.get(&err, [](int dev) {
    TileSetup t = {cudaFuncSetAttribute(adm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)kSmemBytes),
                   0, 0};
    if (t.err == cudaSuccess) t.err = cudaDeviceGetAttribute(&t.sms, cudaDevAttrMultiProcessorCount, dev);
    if (t.err == cudaSuccess) {
      t.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&t.per_sm, adm_tile_kernel, kThreadsAdm,
                                                            kSmemBytes);
    }
    if (t.err == cudaSuccess && t.per_sm == 0) t.err = cudaErrorInvalidConfiguration;
    return t;
  });
  return setup != nullptr ? *setup : TileSetup{err, 0, 0};
}

}  // namespace

extern "C" {

// Number of per-block partials tm_adm_level writes per frame for a ch x cw
// band plane with centre region [top, ch-top) x [left, cw-left): the caller
// sizes `parts` as B*nblk*6 floats.
int tm_adm_blocks(int ch, int cw, int top, int left) { return adm_blocks(ch, top, left, cw - left); }

// What adm_tile_kernel takes on this card: out[0] registers per thread,
// out[1] dynamic shared memory per block in bytes, out[2] resident blocks
// per SM, out[3] local memory per thread in bytes (spills).
int tm_adm_tile_attrs(int* out) {
  const TileSetup t = tile_setup();
  cudaFuncAttributes a;
  cudaError_t err = t.err;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, adm_tile_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)kSmemBytes;
  out[2] = t.per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// One ADM level of the pair `in` (2, B, h, w): sums[b * sums_pstride + band *
// 2 + {0, 1}] = (sum |masked csf*r|^3, sum |csf*o|^3) over the summed window:
// the rows [top, ch-top) of the centre region (top: its crop per side) and
// the band columns [clo, chi) (0 <= clo <= chi <= cw; the centre's [left,
// cw-left) for a whole frame; clo == chi: zeros); with approx non-null also
// the A bands (2, B, ch, cw), whole.  taps: db2 lo[4] then hi[4]; rf_hv, rf_d: the CSF
// factors; cos1: cos^2(1 deg); eps: the decoupling epsilon; m_centre,
// m_edge: the mask weights.  parts holds B*tm_adm_blocks(...)*6 floats, the
// only scratch.
int tm_adm_level(const float* in, int bsz, int h, int w, const float* taps, float rf_hv,
                 float rf_d, float cos1, float eps, float m_centre, float m_edge, int top,
                 int clo, int chi, float* approx, float* parts, float* sums, int sums_pstride,
                 void* stream) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  if (clo < 0 || clo > chi || chi > cw || top < 0 || 2 * top > ch) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileSetup setup = tile_setup();
  if (setup.err != cudaSuccess) return (int)setup.err;
  AdmConsts c;
  for (int k = 0; k < kTaps; ++k) {
    c.lo[k] = taps[k];
    c.hi[k] = taps[kTaps + k];
  }
  c.cos1 = cos1;
  c.f = {rf_hv, rf_d, eps, m_centre, m_edge};
  const AdmGrid g = adm_grid(h, w, top, clo);
  const int tiles = g.nx * g.ny * bsz;
  const int grid = tiles < setup.per_sm * setup.sms ? tiles : setup.per_sm * setup.sms;
  CUtensorMap tmap = {};
  const int use_tma = raw_tensor_map(&tmap, in, bsz, h, w);
  adm_tile_kernel<<<grid, kThreadsAdm, kSmemBytes, s>>>(in, tmap, use_tma, bsz, h, w, top, clo, chi, c,
                                                        approx, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<6><<<bsz, kReduceThreads, 0, s>>>(parts, adm_blocks(ch, top, clo, chi), sums,
                                                         sums_pstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
