// One level of ADM with fixed-point (integer) conventions on Hopper
// (sm_90a): the integer db2 DWT of a (reference, distorted) luma pair, the
// integer angle gate, and the float finish of #18 (decoupling, CSF, the 3x3
// masks and the centre-region cube sums) on the dequantised bands, per
// frame.  Built and bound like the other sources (plain C entry point,
// caller's stream, returns cudaGetLastError()).
//
// No TPU kernel: the JAX package computes this with jnp only
// (turbo_metrics_tpu/ops/integer_adm.py integer_adm_levels l.63 and
// integer_adm_stats l.107, ported as ops/integer_adm.py).
// tm_integer_adm_level runs once per level (ops/kernels/integer_adm.py
// integer_adm_stats).
//
// The schedule (ops/integer_adm.py): level 0's input is (x - 128) << 8 of
// the luma codes, pre-rounded to 8 bits where depth > 8; each 1-D analysis
// pass, rows first, then the columns of the rows' rounded int32 results, is
// (sum_k c[k] x[2i - 1 + k] + 2^12) >> 13 with the Q13 taps, half-sample
// symmetric extension and ceil(n/2) outputs; the gate takes the bands >> 6
// (Q2): dp = oh2 th2 + ov2 tv2, omag, tmag in int32, then dp >= 0 and
// f32(dp) f32(dp) >= cos^2(1 deg) (f32(omag) f32(tmag)), each a single f32
// multiply of exact integers; the finish runs on band * 2^(level+1) / 2^8.
//
// Arithmetic: int32 sums are formed in uint32 and read as int32 (the plain
// version's int32 wraparound; signed overflow in C++ is undefined); every
// true sum is < 2^31 in magnitude.  `>>` of a negative int32 is arithmetic
// in nvcc (sign-extending), which the rounding shifts and the gate's >> 6
// rely on, as the plain version's does.  The finish is adm_tile.cuh's, the
// same code and order as #18 (every f32 operation rounded on its own).
//
// What bounds it on this card: device-memory traffic by the algorithm (per
// pixel of the pair at level 0 2 bytes of u8 codes in and the A bands out
// at a quarter of the pixels, against ~30 int32 and ~30 f32 operations), in
// practice the latency of each tile's dependent chains.  The design is
// #18's (adm.cu, adm_tile.cuh) with integer arithmetic:
//   * a persistent block of 8 warps walks 32x32 tiles of band pixels of one
//     frame, both images, on adm_tile.cuh's grid;
//   * a tile's 70 input rows x 76 columns of each image stay in shared
//     memory at the input's own type (RawTile<T>: 13,568 B for both images
//     at u8, 42,752 as int32); thread 0 starts the next tile's two boxes as
//     tensor copies as soon as the row pass has read the current one, so
//     the copy runs under the column pass and the mask; where the tensor
//     copy does not take the input, the compute warps load it (load_raw).
//     Level 0 converts the codes where the row pass reads them;
//   * the integer row pass (lo and hi) goes to shared memory, the integer
//     column pass, gate and the finish's decoupling run at the halo ring
//     (threads 0-131, while the others go on to their rows) and then at the
//     interior, where the A bands (the next level's input) are written and
//     |csf*r|, |csf*o| stay in registers; |csf*a| goes to shared memory;
//     then adm_tile.cuh's masks, cubes and partials.
// Dynamic shared memory per block: 65,536 B from u8 codes and 74,496 from
// u16 (three blocks per SM), 94,720 from int32 codes and A bands (two).
// With kCheck the kernel also writes the integer surface: the six detail
// bands and the gate (0/1), int32.
//
// Only a window of band columns [clo, chi) adds to the sums: the centre
// region's [left, cw-left) for a whole frame, or a column strip's owned part
// of the frame's centre (ops/adm.py level_windows), as in #18.  Every tile
// still writes its A bands.
//
// Layouts (all contiguous; ch = ceil(h/2), cw = ceil(w/2)):
//   in     (2, B, h, w)      luma codes uint8 / uint16 / int32 (level 0), or
//                            the previous level's int32 A bands
//   approx (2, B, ch, cw)    int32 the A bands of ref and dis (the next level's input)
//   parts  (B, nblk, 6)      f32 per-32x8-block partial cube sums of the summed window
//   sums   (B, ...)          f32 at sums[b * sums_pstride + band * 2 + {0 num, 1 den}]
//   check  (7, B, ch, cw)    int32 o_h, o_v, o_d, t_h, t_v, t_d, angle_ok (kCheck)

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adm_tile.cuh"
#include "per_device.cuh"

namespace {

constexpr int kQTaps = 13;  // Q13 taps: passes round by 2^12 and shift by 13

struct IntAdmConsts {
  int lo[kAdmTaps], hi[kAdmTaps];  // Q13 db2 analysis taps
  float cos1;                      // cos^2(1 deg), f32
  float scale;                     // 2^(level+1) / 2^8: Q8 bands to orthonormal units
  AdmFinish f;                     // the finish's constants
};

// The shared memory of an instance reading T: the raw rows, the row passes,
// |csf*a| and the mbarrier.
template <typename T>
struct IntTile {
  static constexpr size_t kSmemBytes =
      RawTile<T>::kBytes + sizeof(int) * 4 * kRowFloats + sizeof(float) * 3 * kBandFloats + 16;
  static constexpr int kMinBlocks = kSmemBytes <= 75 * 1024 ? 3 : 2;
};

// (sum_k taps[k] x[k] + 2^12) >> 13 in int32 wraparound (x[k] = load(k)).
template <typename Load>
__device__ __forceinline__ int dec_q(const int (&taps)[kAdmTaps], Load load) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kAdmTaps; ++k) acc += static_cast<uint32_t>(taps[k]) * static_cast<uint32_t>(load(k));
  return static_cast<int>(acc + (1u << (kQTaps - 1))) >> kQTaps;  // arithmetic shift
}

// Raw samples 1 .. 6 of the 8 at r (a raw row at a multiple of 4 samples),
// as int: two 16-, 8- or 4-byte loads, by the sample's width.
template <typename T>
__device__ __forceinline__ void raw_six(const T* r, int (&x)[6]) {
  alignas(16) T v[8];
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(r);
    *reinterpret_cast<int4*>(v + 4) = *reinterpret_cast<const int4*>(r + 4);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(r);
    *reinterpret_cast<uint2*>(v + 4) = *reinterpret_cast<const uint2*>(r + 4);
  } else {
    *reinterpret_cast<uint32_t*>(v) = *reinterpret_cast<const uint32_t*>(r);
    *reinterpret_cast<uint32_t*>(v + 4) = *reinterpret_cast<const uint32_t*>(r + 4);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = static_cast<int>(v[1 + i]);
}

// Level 0's input sample from a luma code: pre-rounded by shift, then (x -
// 128) << 8, in int32 wraparound.
__device__ __forceinline__ int code_q(int v, int shift) {
  if (shift > 0) v = static_cast<int>(static_cast<uint32_t>(v) + (1u << (shift - 1))) >> shift;
  return static_cast<int>((static_cast<uint32_t>(v) - 128u) << 8);
}

// The integer column pass at kOut band pixels li0 .. li0+kOut-1 of column lj
// from the row-filtered planes rows[image][lo, hi][lr][lj]: dwt[o][image][A,
// H, V, D] (A = lo taps on lo rows, H = lo on hi, V = hi on lo, D = hi on
// hi), each the rounded int32 sum of its four taps.
template <int kOut>
__device__ __forceinline__ void column_pass_q(const int* __restrict__ rows, int li0, int lj,
                                              const IntAdmConsts& c, int (&dwt)[kOut][2][4]) {
  const int* base = rows + 2 * li0 * kBand + lj;
  uint32_t acc[kOut][2][4];
#pragma unroll
  for (int r = 0; r < 2 * kOut + 2; ++r) {
    uint32_t x[2][2];  // [image][lo, hi]
#pragma unroll
    for (int im = 0; im < 2; ++im) {
      x[im][0] = static_cast<uint32_t>(base[(2 * im) * kRowFloats + r * kBand]);
      x[im][1] = static_cast<uint32_t>(base[(2 * im + 1) * kRowFloats + r * kBand]);
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int k = r - 2 * o;
      if (k >= 0 && k < kAdmTaps) {
        const uint32_t lo = static_cast<uint32_t>(c.lo[k]), hi = static_cast<uint32_t>(c.hi[k]);
#pragma unroll
        for (int im = 0; im < 2; ++im) {
          const uint32_t t[4] = {lo * x[im][0], lo * x[im][1], hi * x[im][0], hi * x[im][1]};
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[o][im][q] = k == 0 ? t[q] : acc[o][im][q] + t[q];
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int im = 0; im < 2; ++im) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dwt[o][im][q] = static_cast<int>(acc[o][im][q] + (1u << (kQTaps - 1))) >> kQTaps;
    }
  }
}

// The integer angle gate of one band pixel (ops/integer_adm.py angle_gate).
__device__ __forceinline__ bool angle_gate_q(const int (&dwt)[2][4], float cos1) {
  const uint32_t oh2 = static_cast<uint32_t>(dwt[0][1] >> 6), ov2 = static_cast<uint32_t>(dwt[0][2] >> 6);
  const uint32_t th2 = static_cast<uint32_t>(dwt[1][1] >> 6), tv2 = static_cast<uint32_t>(dwt[1][2] >> 6);
  const int dp = static_cast<int>(oh2 * th2 + ov2 * tv2);
  const int omag = static_cast<int>(oh2 * oh2 + ov2 * ov2);
  const int tmag = static_cast<int>(th2 * th2 + tv2 * tv2);
  const float dpf = __int2float_rn(dp);
  return dp >= 0 &&
         __fmul_rn(dpf, dpf) >= __fmul_rn(cos1, __fmul_rn(__int2float_rn(omag), __int2float_rn(tmag)));
}

// The gate, then the finish's decoupling and CSF on the dequantised bands.
__device__ __forceinline__ BandPixel gate_csf_q(const int (&dwt)[2][4], const IntAdmConsts& c, bool& angle_ok) {
  angle_ok = angle_gate_q(dwt, c.cos1);
  float o[3], t[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    o[q] = __fmul_rn(__int2float_rn(dwt[0][q + 1]), c.scale);
    t[q] = __fmul_rn(__int2float_rn(dwt[1][q + 1]), c.scale);
  }
  return decouple_csf(o, t, angle_ok, c.f);
}

// ---------------------------------------------------------------------------
// A persistent block of 8 warps walks the 32x32 tiles of band pixels t =
// blockIdx.x, blockIdx.x + gridDim.x, ... of adm_tile.cuh's grid (anchored
// at the summed window's origin (top, clo); t = (b ny + ty) nx + tx).  Per
// tile: the
// raw rows (tensor copies when use_tma, tmap the input's map, else loads),
// the integer row pass into shared memory, the copy of the next tile's raw
// rows started, the integer column pass, gate, decoupling and CSF at the
// halo ring and at the tile (there also the A bands into approx, and with
// kCheck the bands and the gate into check), the masks and the cubes at the
// pixels of the summed window [top, ch-top) x [clo, chi), and each 32x8 sub-tile's six partials into
// parts[(b * nblk + blk) * 6 + k] (reduce_frames_kernel<6> then sums them
// in f64).  Warps 2s and 2s + 1 hold rows 0-3 and 4-7 of sub-tile s, one
// column per lane.
// grid: (min(tiles, resident blocks)), block: kThreadsAdm (1-D), dynamic
// shared memory: IntTile<T>::kSmemBytes.
// ---------------------------------------------------------------------------
template <typename T, bool kCodes, bool kCheck>
__global__ void __launch_bounds__(kThreadsAdm, IntTile<T>::kMinBlocks)
integer_adm_kernel(const T* __restrict__ in, const __grid_constant__ CUtensorMap tmap, int use_tma, int bsz, int h,
                   int w, int shift, int top, int clo, int chi, const __grid_constant__ IntAdmConsts c,
                   int* __restrict__ approx, float* __restrict__ parts, int* __restrict__ check) {
  using RT = RawTile<T>;
  extern __shared__ __align__(128) unsigned char smem_b[];
  T* raw = reinterpret_cast<T*>(smem_b);                      // [2 images][RT::kStride]: kInRows x RT::kW each
  int* rows = reinterpret_cast<int*>(smem_b + RT::kBytes);    // [2 images][lo, hi][kInRows][kBand]
  float* ca = reinterpret_cast<float*>(rows + 4 * kRowFloats);  // [H, V, D][kBand][kBand] |csf*a|
  float* xch = reinterpret_cast<float*>(rows);  // rows 4-7 of each sub-tile's cubes, once rows is dead
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
    // samples 4m+1 .. 4m+6 (input columns s .. s+5, s = 2 bx0 - 3 + 2 lj0),
    // level 0's codes converted here.
    if (threadIdx.x < kRowLanes) {
      const int m = threadIdx.x % kPairs, off = raw_off<T>(bx0);
      for (int rr = threadIdx.x / kPairs; rr < 2 * kInRows; rr += kRowLanes / kPairs) {
        const int im = rr >= kInRows, lr = rr - im * kInRows;
        int x[6];
        raw_six(raw + im * RT::kStride + lr * RT::kW + off + 4 * m, x);
        if constexpr (kCodes) {
#pragma unroll
          for (int i = 0; i < 6; ++i) x[i] = code_q(x[i], shift);
        }
        int* lo = rows + (2 * im) * kRowFloats + lr * kBand;
        int* hi = lo + kRowFloats;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lj = 2 * m - (bx0 & 1) + e;
          if (lj >= 0 && lj < kBand) {
            auto load = [&x, e](int k) { return x[2 * e + k]; };
            lo[lj] = dec_q(c.lo, load);
            hi[lj] = dec_q(c.hi, load);
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

    // Column pass, gate, decoupling and CSF: first at the halo ring, ...
    for (int i = threadIdx.x; i < kHalo; i += kThreadsAdm) {
      int li, lj;
      halo_pixel(i, li, lj);
      int dwt[1][2][4];
      column_pass_q<1>(rows, li, lj, c, dwt);
      bool angle_ok;
      put_mask(ca, li, lj, gate_csf_q(dwt[0], c, angle_ok));
    }
    // ... then at the interior: column lane, the warp's four rows; |csf*r|
    // and |csf*o| stay in registers.
    const int gj = bx0 + lane;
    const int row0 = sub * kBy + half * kRowsPerWarp;  // the warp's first row in the tile
    float cr[kRowsPerWarp][3], co[kRowsPerWarp][3];
    {
      int dwt[kRowsPerWarp][2][4];
      column_pass_q<kRowsPerWarp>(rows, 1 + row0, lane + 1, c, dwt);
#pragma unroll
      for (int o = 0; o < kRowsPerWarp; ++o) {
        const int gi = by0 + row0 + o;
        bool angle_ok;
        const BandPixel p = gate_csf_q(dwt[o], c, angle_ok);
        put_mask(ca, 1 + row0 + o, lane + 1, p);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          cr[o][q] = p.cr[q];
          co[o][q] = p.co[q];
        }
        if (gi >= 0 && gi < ch && gj >= 0 && gj < cw) {
          const size_t nb = (size_t)ch * cw, at = (size_t)gi * cw + gj;
          if (approx != nullptr) {
            approx[(size_t)b * nb + at] = dwt[o][0][0];
            approx[((size_t)bsz + b) * nb + at] = dwt[o][1][0];
          }
          if constexpr (kCheck) {
            const size_t plane = (size_t)bsz * nb;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              check[q * plane + (size_t)b * nb + at] = dwt[o][0][q + 1];
              check[(3 + q) * plane + (size_t)b * nb + at] = dwt[o][1][q + 1];
            }
            check[6 * plane + (size_t)b * nb + at] = angle_ok ? 1 : 0;
          }
        }
      }
    }
    __syncthreads();

    // The masks and the cubes at the summed window, then the partials.
    mask_cubes_partials(ca, xch, cr, co, b, by0, bx0, row0, ch, cw, top, clo, chi, nbx, nby, c.f, parts);
  }
}

// Allows the instance its dynamic shared memory and reads how many of its
// blocks the card holds at once: once per device (per_device.cuh), before
// the first launch or occupancy query on it.
struct TileSetup {
  cudaError_t err;
  int per_sm, sms;
};

template <typename T, bool kCodes, bool kCheck>
TileSetup tile_setup() {
  static tm_setup::PerDevice<TileSetup> setups;
  cudaError_t err = cudaSuccess;
  const TileSetup* setup = setups.get(&err, [](int dev) {
    const auto kernel = integer_adm_kernel<T, kCodes, kCheck>;
    constexpr int kBytes = (int)IntTile<T>::kSmemBytes;
    TileSetup t = {cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes), 0, 0};
    if (t.err == cudaSuccess) t.err = cudaDeviceGetAttribute(&t.sms, cudaDevAttrMultiProcessorCount, dev);
    if (t.err == cudaSuccess) t.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&t.per_sm, kernel, kThreadsAdm, kBytes);
    if (t.err == cudaSuccess && t.per_sm == 0) t.err = cudaErrorInvalidConfiguration;
    return t;
  });
  return setup != nullptr ? *setup : TileSetup{err, 0, 0};
}

struct Args {
  const void* in;
  int bsz, h, w, shift, top, clo, chi;
  IntAdmConsts c;
  int* approx;
  float *parts, *sums;
  int sums_pstride;
  int* check;
  cudaStream_t s;
};

template <typename T, bool kCodes, bool kCheck>
int launch(const Args& a) {
  const TileSetup setup = tile_setup<T, kCodes, kCheck>();
  if (setup.err != cudaSuccess) return (int)setup.err;
  const AdmGrid g = adm_grid(a.h, a.w, a.top, a.clo);
  const int tiles = g.nx * g.ny * a.bsz;
  const int grid = tiles < setup.per_sm * setup.sms ? tiles : setup.per_sm * setup.sms;
  const T* in = static_cast<const T*>(a.in);
  CUtensorMap tmap = {};
  const int use_tma = raw_tensor_map(&tmap, in, a.bsz, a.h, a.w);
  integer_adm_kernel<T, kCodes, kCheck><<<grid, kThreadsAdm, IntTile<T>::kSmemBytes, a.s>>>(
      in, tmap, use_tma, a.bsz, a.h, a.w, a.shift, a.top, a.clo, a.chi, a.c, a.approx, a.parts, a.check);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ch = (a.h + 1) / 2;
  reduce_frames_kernel<6><<<a.bsz, kReduceThreads, 0, a.s>>>(a.parts, adm_blocks(ch, a.top, a.clo, a.chi), a.sums,
                                                             a.sums_pstride);
  return (int)cudaGetLastError();
}

template <typename T, bool kCodes, bool kCheck>
int attrs(int* out) {
  const TileSetup t = tile_setup<T, kCodes, kCheck>();
  cudaFuncAttributes fa;
  cudaError_t err = t.err;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, integer_adm_kernel<T, kCodes, kCheck>);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)IntTile<T>::kSmemBytes;
  out[2] = t.per_sm;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

// The instance of (codes, luma type, check), handed to F: level 0 reads
// uint8 (type 0), uint16 (1) or int32 (2) codes, levels 1-3 the int32 A
// bands (type 2).
template <bool kCheck, typename F>
int dispatch(int codes, int type, F&& f) {
  if (!codes) return type == 2 ? f.template operator()<int, false, kCheck>() : (int)cudaErrorInvalidValue;
  switch (type) {
    case 0: return f.template operator()<uint8_t, true, kCheck>();
    case 1: return f.template operator()<uint16_t, true, kCheck>();
    case 2: return f.template operator()<int, true, kCheck>();
    default: return (int)cudaErrorInvalidValue;
  }
}

struct Launch {
  const Args& a;
  template <typename T, bool kCodes, bool kCheck>
  int operator()() const { return launch<T, kCodes, kCheck>(a); }
};

struct Attrs {
  int* out;
  template <typename T, bool kCodes, bool kCheck>
  int operator()() const { return attrs<T, kCodes, kCheck>(out); }
};

}  // namespace

extern "C" {

// Number of per-block partials tm_integer_adm_level writes per frame for a
// ch x cw band plane with centre region [top, ch-top) x [left, cw-left): the
// caller sizes `parts` as B*nblk*6 floats.
int tm_integer_adm_blocks(int ch, int cw, int top, int left) { return adm_blocks(ch, top, left, cw - left); }

// What integer_adm_kernel takes on this card for level 0's codes (codes !=
// 0) of `type` (0 uint8, 1 uint16, 2 int32) or a later level's A bands
// (codes == 0, type 2), with the check stores (check != 0) or without:
// out[0] registers per thread, out[1] dynamic shared memory per block in
// bytes, out[2] resident blocks per SM, out[3] local memory per thread in
// bytes (spills).
int tm_integer_adm_attrs(int codes, int type, int check, int* out) {
  const Attrs f{out};
  return check ? dispatch<true>(codes, type, f) : dispatch<false>(codes, type, f);
}

// One fixed-point ADM level of the pair `in` (2, B, h, w): level 0 (codes
// != 0) luma codes of `type` pre-rounded by `shift` (depth - 8 above 8 bits,
// else 0), a later level (codes == 0) the int32 A bands the one before
// wrote.  sums[b * sums_pstride + band * 2 + {0, 1}] = (sum |masked
// csf*r|^3, sum |csf*o|^3) over the summed window: the rows [top, ch-top) of
// the bands' centre region (top: its crop per side) and the band columns
// [clo, chi) (0 <= clo <= chi <= cw; the centre's [left, cw-left) for a
// whole frame; clo == chi: zeros); with approx non-null also the int32 A
// bands (2, B, ch, cw), whole; with check non-null the bands o_h .. t_d and the gate (7, B, ch, cw)
// int32.  taps: Q13 lo[4] then hi[4]; cos1: cos^2(1 deg); scale:
// 2^(level+1) / 2^8; rf_hv, rf_d: the CSF factors; eps: the decoupling
// epsilon; m_centre, m_edge: the mask weights.  parts holds
// B*tm_integer_adm_blocks(...)*6 floats, the only scratch.
int tm_integer_adm_level(const void* in, int codes, int type, int shift, int bsz, int h, int w, const int* taps,
                         float cos1, float scale, float rf_hv, float rf_d, float eps, float m_centre,
                         float m_edge, int top, int clo, int chi, int* approx, float* parts, float* sums,
                         int sums_pstride, int* check, void* stream) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  if (clo < 0 || clo > chi || chi > cw || top < 0 || 2 * top > ch) return (int)cudaErrorInvalidValue;
  IntAdmConsts c;
  for (int k = 0; k < kAdmTaps; ++k) {
    c.lo[k] = taps[k];
    c.hi[k] = taps[kAdmTaps + k];
  }
  c.cos1 = cos1;
  c.scale = scale;
  c.f = {rf_hv, rf_d, eps, m_centre, m_edge};
  const Args a{in, bsz, h, w, shift, top, clo, chi, c, approx, parts, sums, sums_pstride, check,
               static_cast<cudaStream_t>(stream)};
  const Launch f{a};
  return check != nullptr ? dispatch<true>(codes, type, f) : dispatch<false>(codes, type, f);
}

}  // extern "C"
