// One scale of VIF with fixed-point (integer) conventions on Hopper (sm_90a):
// the five integer blurs of a (reference, distorted) luma pair (mu1, mu2 in
// Q4; blur(x^2), blur(y^2), blur(xy) in Q8), the int32 moments, the guarded
// f32 num/den map with its two log2, per-frame sums of num and den, and,
// optionally, the next scale's input.  Built and bound like the other
// sources (plain C entry point, caller's stream, returns
// cudaGetLastError()).
//
// No TPU kernel: the JAX package computes this with jnp only
// (turbo_metrics_tpu/ops/integer_vif.py integer_vif_scale_planes l.57 and
// integer_vif_stats l.100, ported as ops/integer_vif.py).  tm_integer_vif_level
// runs once per scale (ops/kernels/integer_vif.py integer_vif_stats).
//
// The schedule (ops/integer_vif.py): taps C1 (Q16) and C2 (Q12) of the
// scale's window; the input pre-rounded to 8 bits where depth > 8, (x +
// 2^(s-1)) >> s; vertical first, vx = (sum C1 x + 2^7) >> 8 and vp = (sum C2
// p + 2^11) >> 12 for p in x*x, y*y, x*y; then horizontal, mu = (sum C2 vx +
// 2^15) >> 16 and pb = (sum C2 vp + 2^3) >> 4; s11 = max(pb_xx - mu1^2, 0),
// s22 likewise, s12 = pb_xy - mu1 mu2; the next scale's input (sum C2e vxe +
// 2^19) >> 20, vxe the vertical pass of the next window's C1e, at even rows
// and columns.  Reflect-101 borders, repeated where a window is wider than
// the plane (level.cuh reflect101).
//
// Arithmetic: native uint32 for every blur.  Each true sum is < 2^32, so the
// wrapped sums are exact, and where they are not (inputs no luma holds) they
// wrap as the plain version's uint32 schedule does.  The moments are formed
// in uint32 and read as int32 (mu1*mu1 and pb - mu1*mu1 as the plain
// version's int32 wraparound; signed overflow in C++ is undefined).  The map
// is f32 with every operation rounded on its own (__fmul_rn, __fdiv_rn, ...),
// so nvcc contracts nothing into FMAs and each term is the plain version's
// f32 value; only the sums (f32 per 32x8 tile in level.cuh's tree, then
// f64) and log2f's last bit differ.
//
// What bounds it on this card: integer multiply-adds.  Per pixel of the
// pair at scale 0 the algorithm needs ~2 bytes in against ~215 integer
// multiply-adds (five quantities, 17 taps, two passes, the vertical pass
// over 48 of every 32 columns) and ~30 f32 operations; IMAD issues at half
// the f32 rate.  The design follows vif_tile_kernel (vif.cu) with the passes
// swapped:
//   * one block of 128 threads per 32x32 output tile of one frame; the
//     tile's input rows y0-R .. y0+31+R and columns x0-R .. x0+31+R of both
//     images go to shared memory as uint32, each at its reflect-101 index,
//     pre-rounded (a thread's 36 loads issued all before their stores
//     measured 9% slower: more registers);
//   * the vertical pass of the five quantities at the tile's 32 rows and
//     all 32+2R columns goes to shared memory (a thread one column of four
//     rows, from a 4+2R-row window), and never reaches device memory;
//   * the horizontal pass, moments and map run on a row segment of eight
//     pixels per thread, each warp one 32x8 sub-tile, so a thread reads each
//     vertical sample once (24 shared loads per quantity for eight outputs
//     at R = 8, not 17 per output); the sub-tile's sums are the threads'
//     (in column order) added by a fixed tree of shuffles;
//   * the next scale's input is computed only where it is kept: the next
//     window's vertical pass at the tile's 16 even rows, its horizontal pass
//     at their 16 even columns (each output is independent, so this is
//     exact), stored as uint16 (every value is < 2^12);
//   * with kCheck, the int32 planes s11, s22, s12, mu1, mu2 too (the exact
//     surface the card's checks hold against the plain version); the main
//     path's instances compile without those stores.
// At R = 8 a block takes 54,912 B of dynamic shared memory (inputs 18,432,
// vertical planes 31,360 at an odd row stride, emission rows 5,120): four
// blocks per SM.
//
// Layouts (all contiguous):
//   in     (2, B, h, w)          luma codes, uint8 / uint16 / int32 (type)
//   parts  (B, nblk, 2)          f32 per-32x8-tile partial sums
//   sums   (B, ...)              f32 num, den at sums[b * sums_pstride + {0, 1}]
//   next   (2, B, ceil(h/2), ceil(w/2)) uint16, the next scale's input
//   check  (5, B, h, w)          int32 s11, s22, s12, mu1, mu2 (kCheck)

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr int kVRows = kBy / 2;  // output rows of a thread's vertical-pass window
constexpr int kHRun = kTileW / 4;  // output columns of a thread's horizontal-pass row segment

// The shared-memory tile of a scale with a window of radius R and a next
// window of radius RE (0: no emission).
template <int R, int RE>
struct ITile {
  static constexpr int kInW = kTileW + 2 * R;            // input columns (x0-R .. x0+31+R)
  static constexpr int kHaloH = kTileH + 2 * R;          // input rows (y0-R .. y0+31+R)
  static constexpr int kIn = kHaloH * kInW;              // one image's input tile
  static constexpr int kVS = kInW | 1;                   // row stride of the vertical planes (odd: no
                                                         // bank conflicts in the horizontal pass)
  static constexpr int kVert = kTileH * kVS;             // one vertically filtered quantity
  static constexpr int kEmitW = kTileW + 2 * RE;         // columns of the emission's vertical pass
  static constexpr int kEmit = RE > 0 ? (kTileH / 2) * kEmitW : 0;  // one image's emission rows
  static constexpr int kVJobs = kInW * (kTileH / kVRows);  // (column, 4-row group) of the vertical pass
  static constexpr size_t kSmemBytes = sizeof(uint32_t) * (2 * kIn + 5 * kVert + 2 * kEmit);
};

// The guarded map of one pixel from its int32 moments (ops/integer_vif.py
// scale_log_sums, in its order): v = (num, den).
__device__ __forceinline__ void ivif_map(int s11i, int s22i, int s12i, float (&v)[2]) {
  const float s11 = __int2float_rn(s11i), s22 = __int2float_rn(s22i), s12 = __int2float_rn(s12i);
  const bool z11 = s11i == 0, z22 = s22i == 0;
  float g = z11 ? 0.0f : __fdiv_rn(s12, s11);
  float sv = __fsub_rn(s22, __fmul_rn(g, s12));
  if (z11) sv = s22;
  const float s11c = z11 ? 0.0f : s11;
  if (z22) sv = 0.0f;
  if (z22) g = 0.0f;
  if (g < 0.0f) sv = s22;
  g = fmaxf(g, 0.0f);
  sv = fmaxf(sv, 1e-10f);
  v[0] = log2f(__fadd_rn(1.0f, __fdiv_rn(__fmul_rn(__fmul_rn(g, g), s11c), __fadd_rn(sv, 512.0f))));
  v[1] = log2f(__fadd_rn(1.0f, __fdiv_rn(s11c, 512.0f)));
}

// ---------------------------------------------------------------------------
// One block per 32x32 output tile of frame blockIdx.z: the tile's input
// samples of both images into shared memory, the vertical pass of the five
// quantities into shared memory, the horizontal pass, moments and map, and
// each 32x8 sub-tile's two partials into parts[(b * nblk + blk) * 2 + k],
// blk = its index in the frame's (ceil(h/8), ceil(w/32)) grid of 32x8 tiles
// (reduce_frames_kernel<2> then sums them in f64).  With RE > 0 also the
// tile's 16x16 pixels of the next scale's input into next; with kCheck the
// moments into check.  coeffs: C1, C2 of this scale (2R+1 each), then C1, C2
// of the next (2RE+1 each).  shift: the pre-rounding shift (0: none).
// grid: (ceil(w/32), ceil(h/32), B), block: kTileThreads (1-D), dynamic
// shared memory: ITile<R, RE>::kSmemBytes.
// ---------------------------------------------------------------------------
template <typename T, int R, int RE, bool kCheck>
__global__ void __launch_bounds__(kTileThreads, 4)
integer_vif_kernel(const T* __restrict__ src, int bsz, int h, int w, int shift, const int* __restrict__ coeffs,
                   float* __restrict__ parts, uint16_t* __restrict__ next, int* __restrict__ check) {
  using Q = ITile<R, RE>;
  extern __shared__ __align__(16) uint32_t smem_u[];
  uint32_t* in = smem_u;                 // [2 images][kHaloH][kInW]
  uint32_t* vert = in + 2 * Q::kIn;      // [vx, vy, vxx, vyy, vxy][kTileH][kVS]
  uint32_t* emit = vert + 5 * Q::kVert;  // [2 images][kTileH / 2][kEmitW]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const size_t npx = (size_t)h * w;

  // Input tiles: rows y0-R .. y0+31+R, columns x0-R .. x0+31+R, each sample
  // at its reflect-101 index, as uint32 (an int32 code as its bits, as the
  // plain version's uint32 cast), pre-rounded.
  {
    const T* a = src + (size_t)b * npx;
    const T* d = src + ((size_t)bsz + b) * npx;
    for (int i = threadIdx.x; i < 2 * Q::kIn; i += kTileThreads) {
      const int img = i / Q::kIn, rem = i - img * Q::kIn;
      const int r = rem / Q::kInW, c = rem - r * Q::kInW;
      const T* p = img ? d : a;
      uint32_t v =
          static_cast<uint32_t>(__ldg(p + (size_t)reflect101(y0 - R + r, h) * w + reflect101(x0 - R + c, w)));
      if (shift > 0) v = (v + (1u << (shift - 1))) >> shift;
      in[i] = v;
    }
  }
  uint32_t c1[2 * R + 1], c2[2 * R + 1], c1e[2 * RE + 1], c2e[2 * RE + 1];
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    c1[k] = static_cast<uint32_t>(__ldg(coeffs + k));
    c2[k] = static_cast<uint32_t>(__ldg(coeffs + 2 * R + 1 + k));
  }
  if constexpr (RE > 0) {
#pragma unroll
    for (int k = 0; k <= 2 * RE; ++k) {
      c1e[k] = static_cast<uint32_t>(__ldg(coeffs + 4 * R + 2 + k));
      c2e[k] = static_cast<uint32_t>(__ldg(coeffs + 4 * R + 2 + 2 * RE + 1 + k));
    }
  }
  __syncthreads();

  // Vertical pass: column c (input column x0 - R + c) of output rows g*4 ..
  // g*4+3, from input rows g*4 .. g*4+3+2R of the tile (row o + k for tap k).
  for (int job = threadIdx.x; job < Q::kVJobs; job += kTileThreads) {
    const int c = job % Q::kInW, g = job / Q::kInW;
    uint32_t s[kVRows][5];
#pragma unroll
    for (int i = 0; i < kVRows + 2 * R; ++i) {
      const uint32_t xa = in[(g * kVRows + i) * Q::kInW + c];
      const uint32_t xd = in[Q::kIn + (g * kVRows + i) * Q::kInW + c];
      const uint32_t x[5] = {xa, xd, xa * xa, xd * xd, xa * xd};
#pragma unroll
      for (int o = 0; o < kVRows; ++o) {
        const int k = i - o;
        if (k >= 0 && k <= 2 * R) {
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            const uint32_t m = (q < 2 ? c1[k] : c2[k]) * x[q];
            s[o][q] = k == 0 ? m : s[o][q] + m;
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kVRows; ++o) {
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        vert[(q * kTileH + g * kVRows + o) * Q::kVS + c] = q < 2 ? (s[o][q] + (1u << 7)) >> 8
                                                                   : (s[o][q] + (1u << 11)) >> 12;
      }
    }
  }
  // The next window's vertical pass at the tile's even rows y0 + 2i, columns
  // x0-RE .. x0+31+RE (input row 2i + R - RE + k for tap k).
  if constexpr (RE > 0) {
    for (int idx = threadIdx.x; idx < 2 * Q::kEmit; idx += kTileThreads) {
      const int img = idx / Q::kEmit, rem = idx - img * Q::kEmit;
      const int i = rem / Q::kEmitW, e = rem - i * Q::kEmitW;
      const uint32_t* p = in + img * Q::kIn + (2 * i + R - RE) * Q::kInW + R - RE + e;
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k <= 2 * RE; ++k) sum += c1e[k] * p[k * Q::kInW];
      emit[idx] = (sum + (1u << 7)) >> 8;
    }
  }
  __syncthreads();

  // Horizontal pass, moments and map: lane l of the warp takes row l / 4 of
  // its 32x8 sub-tile and that row's eight columns c0 .. c0+7, c0 = 8 (l %
  // 4), reading each vertical sample once (output o, tap k: vertical column
  // c0 + o + k).
  const int row = warp * kBy + lane / 4, c0 = kHRun * (lane % 4);
  const int gr = y0 + row;
  uint32_t acc[kHRun][5];
#pragma unroll
  for (int j = 0; j < kHRun + 2 * R; ++j) {
    uint32_t x[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) x[q] = vert[(q * kTileH + row) * Q::kVS + c0 + j];
#pragma unroll
    for (int o = 0; o < kHRun; ++o) {
      const int k = j - o;
      if (k >= 0 && k <= 2 * R) {
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const uint32_t m = c2[k] * x[q];
          acc[o][q] = k == 0 ? m : acc[o][q] + m;
        }
      }
    }
  }
  // The thread's num and den over its eight pixels, in column order.
  float v[2] = {0.0f, 0.0f};
#pragma unroll
  for (int o = 0; o < kHRun; ++o) {
    const int gc = x0 + c0 + o;
    const uint32_t mu1 = (acc[o][0] + (1u << 15)) >> 16, mu2 = (acc[o][1] + (1u << 15)) >> 16;
    const uint32_t pxx = (acc[o][2] + 8u) >> 4, pyy = (acc[o][3] + 8u) >> 4, pxy = (acc[o][4] + 8u) >> 4;
    const int s11 = max(static_cast<int>(pxx - mu1 * mu1), 0);
    const int s22 = max(static_cast<int>(pyy - mu2 * mu2), 0);
    const int s12 = static_cast<int>(pxy - mu1 * mu2);
    const bool in_plane = gr < h && gc < w;
    if constexpr (kCheck) {
      if (in_plane) {
        const size_t at = (size_t)b * npx + (size_t)gr * w + gc, plane = (size_t)bsz * npx;
        check[at] = s11;
        check[plane + at] = s22;
        check[2 * plane + at] = s12;
        check[3 * plane + at] = static_cast<int>(mu1);
        check[4 * plane + at] = static_cast<int>(mu2);
      }
    }
    float nd[2] = {0.0f, 0.0f};
    if (in_plane) ivif_map(s11, s22, s12, nd);
#pragma unroll
    for (int k = 0; k < 2; ++k) v[k] = o == 0 ? nd[k] : __fadd_rn(v[k], nd[k]);
  }
  // The sub-tile's two sums: the lanes' added in a fixed tree of shuffles,
  // written by lane 0 to parts[(b * nby + by) * nbx + bx] (the frame's
  // pixel_grid) where the sub-tile (bx, by) lies inside the plane.
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      v[k] = __fadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], stride));
    }
  }
  const int nbx = (w + kBx - 1) / kBx, nby = (h + kBy - 1) / kBy, by = blockIdx.y * kSubTiles + warp;
  if (lane == 0 && by < nby) {
    float* out = parts + ((size_t)b * nby + by) * nbx * 2 + (size_t)blockIdx.x * 2;
    out[0] = v[0];
    out[1] = v[1];
  }

  // The next window's horizontal pass at the even columns x0 + 2m of the
  // even rows: next scale pixel (y0/2 + i, x0/2 + m) of both images.
  if constexpr (RE > 0) {
    const int he = (h + 1) / 2, we = (w + 1) / 2;
    for (int idx = threadIdx.x; idx < 2 * (kTileH / 2) * (kTileW / 2); idx += kTileThreads) {
      const int img = idx / ((kTileH / 2) * (kTileW / 2)), i = idx / (kTileW / 2) % (kTileH / 2);
      const int m = idx % (kTileW / 2);
      const int ni = y0 / 2 + i, nj = x0 / 2 + m;
      if (ni >= he || nj >= we) continue;
      const uint32_t* p = emit + (img * (kTileH / 2) + i) * Q::kEmitW + 2 * m;
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k <= 2 * RE; ++k) sum += c2e[k] * p[k];
      next[(((size_t)img * bsz + b) * he + ni) * we + nj] = static_cast<uint16_t>((sum + (1u << 19)) >> 20);
    }
  }
}

int vif_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// Allows the instance its dynamic shared memory: once per process (the
// function-local static), before its first launch or occupancy query.
template <typename T, int R, int RE, bool kCheck>
cudaError_t tile_setup() {
  static const cudaError_t err =
      cudaFuncSetAttribute(integer_vif_kernel<T, R, RE, kCheck>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)ITile<R, RE>::kSmemBytes);
  return err;
}

struct Args {
  const void* in;
  int bsz, h, w, shift;
  const int* coeffs;
  float *parts, *sums;
  int sums_pstride;
  uint16_t* next;
  int* check;
  cudaStream_t s;
};

template <typename T, int R, int RE, bool kCheck>
int launch(const Args& a) {
  cudaError_t err = tile_setup<T, R, RE, kCheck>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH, a.bsz);
  integer_vif_kernel<T, R, RE, kCheck><<<grid, kTileThreads, ITile<R, RE>::kSmemBytes, a.s>>>(
      static_cast<const T*>(a.in), a.bsz, a.h, a.w, a.shift, a.coeffs, a.parts, a.next, a.check);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<2><<<a.bsz, kReduceThreads, 0, a.s>>>(a.parts, vif_blocks(a.h, a.w), a.sums,
                                                             a.sums_pstride);
  return (int)cudaGetLastError();
}

template <typename T, int R, int RE, bool kCheck>
int attrs(int* out) {
  cudaError_t err = tile_setup<T, R, RE, kCheck>();
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, integer_vif_kernel<T, R, RE, kCheck>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integer_vif_kernel<T, R, RE, kCheck>,
                                                        kTileThreads, ITile<R, RE>::kSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)ITile<R, RE>::kSmemBytes;
  out[2] = per_sm;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

// The instance of (scale, luma type, check), handed to F: scale 0 reads
// uint8 (type 0), uint16 (1) or int32 (2) codes, scales 1-3 the uint16
// planes scale 0-2 emitted.
template <bool kCheck, typename F>
int dispatch(int scale, int type, F&& f) {
  switch (scale) {
    case 0:
      switch (type) {
        case 0: return f.template operator()<uint8_t, 8, 4, kCheck>();
        case 1: return f.template operator()<uint16_t, 8, 4, kCheck>();
        case 2: return f.template operator()<int, 8, 4, kCheck>();
        default: return (int)cudaErrorInvalidValue;
      }
    case 1: return type == 1 ? f.template operator()<uint16_t, 4, 2, kCheck>() : (int)cudaErrorInvalidValue;
    case 2: return type == 1 ? f.template operator()<uint16_t, 2, 1, kCheck>() : (int)cudaErrorInvalidValue;
    case 3: return type == 1 ? f.template operator()<uint16_t, 1, 0, kCheck>() : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

struct Launch {
  const Args& a;
  template <typename T, int R, int RE, bool kCheck>
  int operator()() const { return launch<T, R, RE, kCheck>(a); }
};

struct Attrs {
  int* out;
  template <typename T, int R, int RE, bool kCheck>
  int operator()() const { return attrs<T, R, RE, kCheck>(out); }
};

}  // namespace

extern "C" {

// Number of 32x8-tile partials tm_integer_vif_level writes per frame of an
// h x w scale: the caller sizes `parts` as B*nblk*2 floats.
int tm_integer_vif_blocks(int h, int w) { return vif_blocks(h, w); }

// What integer_vif_kernel takes at VIF scale `scale` (0-3) on luma of
// `type` (0 uint8, 1 uint16, 2 int32; scales 1-3: 1), with the check stores
// (check != 0) or without: out[0] registers per thread, out[1] dynamic
// shared memory per block in bytes, out[2] resident blocks per SM, out[3]
// local memory per thread in bytes (spills).
int tm_integer_vif_attrs(int scale, int type, int check, int* out) {
  const Attrs f{out};
  return check ? dispatch<true>(scale, type, f) : dispatch<false>(scale, type, f);
}

// Fixed-point VIF scale `scale` (0-3) of the pair `in` (2, B, h, w) of luma
// codes of `type` -> sums[b * sums_pstride + {0, 1}] = (num, den).  shift:
// the pre-rounding shift (depth - 8 at scale 0 above 8 bits, else 0).
// coeffs (device int32): C1, C2 of this scale's window, then C1, C2 of the
// next scale's (scales 0-2).  With scale < 3 it also writes `next` (2, B,
// ceil(h/2), ceil(w/2)) uint16, the next scale's input; with check non-null
// the moments (5, B, h, w) int32 s11, s22, s12, mu1, mu2.  parts holds
// B*tm_integer_vif_blocks(h, w)*2 floats, the only scratch.
int tm_integer_vif_level(const void* in, int type, int bsz, int h, int w, int scale, int shift,
                         const int* coeffs, float* parts, float* sums, int sums_pstride, uint16_t* next,
                         int* check, void* stream) {
  const Args a{in, bsz, h, w, shift, coeffs, parts, sums, sums_pstride, next, check,
               static_cast<cudaStream_t>(stream)};
  const Launch f{a};
  return check != nullptr ? dispatch<true>(scale, type, f) : dispatch<false>(scale, type, f);
}

}  // extern "C"
