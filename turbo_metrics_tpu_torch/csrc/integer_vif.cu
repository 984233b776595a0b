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
// wrap as the plain version's uint32 schedule does.  Every window is
// symmetric (c[k] == c[2R-k], checked on the host), so a blur is folded:
// c[R] x[R] + sum_{k<R} c[k] (x[k] + x[2R-k]), R + 1 multiply-adds and R
// adds instead of 2R + 1 multiply-adds; uint32 arithmetic is a ring mod 2^32,
// so the folded sum is the wrapped sum bit for bit, for any codes.  The
// moments are formed in uint32 and read as int32 (mu1*mu1 and pb - mu1*mu1
// as the plain version's int32 wraparound; signed overflow in C++ is
// undefined).  The map is f32 with every operation rounded on its own
// (__fmul_rn, __fdiv_rn, ...), so nvcc contracts nothing into FMAs and each
// term is the plain version's f32 value; only the sums (f32 per 32x8 tile
// in level.cuh's tree, then f64) and log2f's last bit differ.
//
// What bounds it on this card: integer multiply-adds.  Per pixel of the
// pair at scale 0 the algorithm needs ~2 bytes in against ~95 folded
// multiply-adds and ~80 adds (five quantities, two passes of 9 + 8) and ~30
// f32 operations; IMAD issues at half the f32 rate.  The design follows
// vif_tile_kernel (vif.cu) with the passes swapped:
//   * one block of 128 threads per 32x32 output tile of one frame; the
//     tile's input rows y0-R .. y0+31+R of both images go to shared memory.
//     Where the tile's rows and the 16-byte chunks around its columns lie
//     inside the plane and the rows are whole chunks (every interior tile at
//     1080p), each thread issues its 16-byte loads all before its first
//     store; elsewhere one load per sample at its reflect-101 index;
//   * the taps are kernel parameters (the constant bank), not registers;
//   * the vertical pass of the five quantities at the tile's 32 rows and
//     all 32+2R columns goes to shared memory (a thread one column of four
//     rows, from a 4+2R-row window, one quantity at a time), and never
//     reaches device memory;
//   * the horizontal pass, moments and map run on a row segment of eight
//     pixels per thread, each warp one 32x8 sub-tile, one quantity at a time
//     (24 shared loads per quantity for eight outputs at R = 8); the
//     sub-tile's sums are the threads' (in column order) added by a fixed
//     tree of shuffles;
//   * the next scale's input is computed only where it is kept: the next
//     window's vertical pass at the tile's 16 even rows, its horizontal pass
//     at their 16 even columns (each output is independent, so this is
//     exact), stored as uint16 (every value is < 2^12);
//   * with kCheck, the int32 planes s11, s22, s12, mu1, mu2 too (the exact
//     surface the card's checks hold against the plain version); the main
//     path's instances compile without those stores.
// Two storage widths (kNarrow, chosen on the host from the luma's type):
// uint8 codes are < 2^8 at every scale, pre-rounded or not (a code
// pre-rounded by s >= 1 is (x + 2^(s-1)) >> s <= (255 + 2^(s-1)) >> s <=
// 128; the next scale's input is a rounded weighted mean of the last one's:
// (sum C2e vxe + 2^19) >> 20 <= (255 * 2^24 + 2^19) >> 20 = 255), so vx <=
// (255 * 2^16 + 2^7) >> 8 = 65280, vp <= (65025 * 2^12 + 2^11) >> 12 =
// 65025 and vxe <= 65280 fit uint16, and so does the input tile (uint16
// rather than the codes' uint8: with uint8 samples nvcc packs them for
// IDP.2A with PRMT, 399 PRMT per thread, 4% slower).  At R = 8 that block
// takes 30,528 B of dynamic shared memory (inputs 12,288, vertical planes
// 15,680 at an odd row stride, emission rows 2,560): six blocks per SM at
// 80 registers (five at 96 measured 6% slower).
// uint16 and int32 codes keep uint32 planes (a uint16 code < 2^depth
// pre-rounds to up to 256, whose vertical sums reach 65536): 54,912 B at
// R = 8, four blocks per SM.  Both widths pre-round the input as it is
// stored.
//
// Only a window [clo, chi) of the scale's columns adds to the sums (0 and w:
// all of them).  A column strip of a frame cut with a halo (parallel/mesh.py
// spatial_sharding; ops/kernels/integer_vif.py) blurs and emits every
// column it holds but sums only the maps of the columns it owns.  A tile
// wholly outside the window skips its five-quantity passes, its moments and
// its map and writes zero partials, the bits its pass would write; it still
// emits its 16x16 pixels of the next scale.  The check instances compute
// every tile whole.
//
// Layouts (all contiguous):
//   in     (2, B, h, w)          luma codes, uint8 / uint16 / int32 (type)
//   parts  (B, nblk, 2)          f32 per-32x8-tile partial sums
//   sums   (B, ...)              f32 num, den at sums[b * sums_pstride + {0, 1}]
//   next   (2, B, ceil(h/2), ceil(w/2)) uint16, the next scale's input
//   check  (5, B, h, w)          int32 s11, s22, s12, mu1, mu2 (kCheck)

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "level.cuh"
#include "per_device.cuh"

namespace {

constexpr int kVRows = kBy / 2;  // output rows of a thread's vertical-pass window
constexpr int kHRun = kTileW / 4;  // output columns of a thread's horizontal-pass row segment

// The folded taps of a scale with a window of radius R and a next window of
// radius RE (0: no emission): c[k] for k = 0 .. R of C1, C2, C1e, C2e (the
// window's other half is the same, reversed).
template <int R, int RE>
struct FoldedTaps {
  uint32_t c1[R + 1], c2[R + 1], c1e[RE + 1], c2e[RE + 1];
};

// sum_k c[k] x(k) over a symmetric window of radius N, folded, in uint32
// (x(k): the sample under tap k).
template <int N, typename X>
__device__ __forceinline__ uint32_t folded_sum(const uint32_t (&c)[N + 1], X x) {
  uint32_t acc = c[N] * x(N);
#pragma unroll
  for (int k = 0; k < N; ++k) acc += c[k] * (x(k) + x(2 * N - k));
  return acc;
}

// The shared-memory tile of a scale with a window of radius R and a next
// window of radius RE, reading luma of type T, narrow or wide.
template <typename T, int R, int RE, bool kNarrow>
struct ITile {
  using In = std::conditional_t<kNarrow, uint16_t, uint32_t>;  // the input tile's samples
  using V = std::conditional_t<kNarrow, uint16_t, uint32_t>;  // vertical planes and emission rows
  static constexpr int kChunk = 16 / (int)sizeof(T);           // samples of a 16-byte chunk of a row
  static constexpr int kPad = (R + kChunk - 1) / kChunk * kChunk;  // chunk-path samples left of x0
  static constexpr int kOff = kPad - R;                        // tile column of input column x0-R
  static constexpr int kRowW = kTileW + 2 * kPad;              // input tile row (x0-kPad .. x0+31+kPad)
  static constexpr int kRowChunks = kRowW / kChunk;
  static constexpr int kInW = kTileW + 2 * R;                  // input columns read (x0-R .. x0+31+R)
  static constexpr int kHaloH = kTileH + 2 * R;                // input rows (y0-R .. y0+31+R)
  static constexpr int kIn = kHaloH * kRowW;                   // one image's input tile
  static constexpr int kLoads = (2 * kHaloH * kRowChunks + kTileThreads - 1) / kTileThreads;  // chunks a thread loads
  static constexpr int kVS = kInW | 1;                         // row stride of the vertical planes (odd: no
                                                               // bank conflicts in the horizontal pass)
  static constexpr int kVert = kTileH * kVS;                   // one vertically filtered quantity
  static constexpr int kEmitW = kTileW + 2 * RE;               // columns of the emission's vertical pass
  static constexpr int kEmit = RE > 0 ? (kTileH / 2) * kEmitW : 0;  // one image's emission rows
  static constexpr int kInBytes = (2 * kIn * (int)sizeof(In) + 15) / 16 * 16;
  static constexpr size_t kSmemBytes = kInBytes + sizeof(V) * (5 * kVert + 2 * kEmit);
  static constexpr int kMinBlocks = kNarrow ? 6 : 4;
  static_assert((kIn * sizeof(In)) % 16 == 0, "an image's input tile is whole 16-byte chunks");
};

// The stored form of an input code: with kRound pre-rounded by shift (> 0;
// an int32 code as its bits, as the plain version's uint32 cast).
template <bool kRound, typename In, typename T>
__device__ __forceinline__ In stored(T v, int shift) {
  uint32_t u = static_cast<uint32_t>(v);
  if constexpr (kRound) u = (u + (1u << (shift - 1))) >> shift;
  return static_cast<In>(u);
}

// The tile's input rows y0-R .. y0+31+R of both images into in[image][row]
// [kRowW], input column x0-R+c at kOff + c, pre-rounded by shift where
// kRound (the caller's branch on shift > 0, so that codes that need none
// run no rounding).  Chunk path (chunks != 0): each thread's 16-byte chunks
// of rows x0-kPad .. x0+31+kPad are all loaded before the first is stored.
// Otherwise each needed sample at its reflect-101 index.
template <typename T, int R, int RE, bool kNarrow, bool kRound>
__device__ __forceinline__ void load_tile(typename ITile<T, R, RE, kNarrow>::In* __restrict__ in,
                                          const T* __restrict__ src, int bsz, int b, int h, int w, int x0, int y0,
                                          int shift, bool chunks) {
  using Q = ITile<T, R, RE, kNarrow>;
  using In = typename Q::In;
  const size_t npx = (size_t)h * w;
  const T* a = src + (size_t)b * npx;
  const T* d = src + ((size_t)bsz + b) * npx;
  if (chunks) {
    constexpr int kPerImage = Q::kHaloH * Q::kRowChunks;
    uint4 v[Q::kLoads];
#pragma unroll
    for (int n = 0; n < Q::kLoads; ++n) {
      const int i = threadIdx.x + n * kTileThreads;
      if (i < 2 * kPerImage) {
        const int img = i / kPerImage, rem = i - img * kPerImage;
        const int r = rem / Q::kRowChunks, k = rem - r * Q::kRowChunks;
        const T* p = (img ? d : a) + (size_t)(y0 - R + r) * w + x0 - Q::kPad + k * Q::kChunk;
        v[n] = __ldg(reinterpret_cast<const uint4*>(p));
      }
    }
#pragma unroll
    for (int n = 0; n < Q::kLoads; ++n) {
      const int i = threadIdx.x + n * kTileThreads;
      if (i < 2 * kPerImage) {
        const int img = i / kPerImage, rem = i - img * kPerImage;
        const int r = rem / Q::kRowChunks, k = rem - r * Q::kRowChunks;
        In* q = in + img * Q::kIn + r * Q::kRowW + k * Q::kChunk;
        if constexpr (std::is_same_v<In, T> && !kRound) {
          *reinterpret_cast<uint4*>(q) = v[n];
        } else {
          alignas(16) T s[Q::kChunk];
          *reinterpret_cast<uint4*>(s) = v[n];
          alignas(16) In u[Q::kChunk];
#pragma unroll
          for (int e = 0; e < Q::kChunk; ++e) u[e] = stored<kRound, In>(s[e], shift);
#pragma unroll
          for (int e = 0; e < Q::kChunk; e += 16 / (int)sizeof(In)) {
            *reinterpret_cast<uint4*>(q + e) = *reinterpret_cast<const uint4*>(u + e);
          }
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * Q::kHaloH * Q::kInW; i += kTileThreads) {
    const int img = i / (Q::kHaloH * Q::kInW), rem = i - img * (Q::kHaloH * Q::kInW);
    const int r = rem / Q::kInW, c = rem - r * Q::kInW;
    const T* p = img ? d : a;
    in[img * Q::kIn + r * Q::kRowW + Q::kOff + c] =
        stored<kRound, In>(__ldg(p + (size_t)reflect101(y0 - R + r, h) * w + reflect101(x0 - R + c, w)), shift);
  }
}

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
// (reduce_frames_kernel<2> then sums them in f64), only the maps of the
// columns [clo, chi) adding.  With RE > 0 also the
// tile's 16x16 pixels of the next scale's input into next; with kCheck the
// moments into check.  taps: the folded C1, C2 of this scale and of the
// next.  shift: the pre-rounding shift (0: none; scale 0 only).
// aligned: the input's rows are whole 16-byte chunks from an aligned base.
// grid: (ceil(w/32), ceil(h/32), B), block: kTileThreads (1-D), dynamic
// shared memory: ITile<T, R, RE, kNarrow>::kSmemBytes.
// ---------------------------------------------------------------------------
template <typename T, int R, int RE, bool kNarrow, bool kCheck>
__global__ void __launch_bounds__(kTileThreads, (ITile<T, R, RE, kNarrow>::kMinBlocks))
integer_vif_kernel(const T* __restrict__ src, int bsz, int h, int w, int shift, int aligned, int clo, int chi,
                   const __grid_constant__ FoldedTaps<R, RE> taps, float* __restrict__ parts, uint16_t* __restrict__ next,
                   int* __restrict__ check) {
  using Q = ITile<T, R, RE, kNarrow>;
  using In = typename Q::In;
  using V = typename Q::V;
  extern __shared__ __align__(16) unsigned char smem_b[];
  In* in = reinterpret_cast<In*>(smem_b);                 // [2 images][kHaloH][kRowW]
  V* vert = reinterpret_cast<V*>(smem_b + Q::kInBytes);   // [vx, vy, vxx, vyy, vxy][kTileH][kVS]
  V* emit = vert + 5 * Q::kVert;                           // [2 images][kTileH / 2][kEmitW]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const int nbx = (w + kBx - 1) / kBx, nby = (h + kBy - 1) / kBy, by = blockIdx.y * kSubTiles + warp;
  // The whole block: the tile's 32 columns all lie outside the window.
  const bool outside = !kCheck && (x0 + kTileW <= clo || x0 >= chi);
  if (outside && RE == 0) {
    if (lane == 0 && by < nby) {
      float* out = parts + ((size_t)b * nby + by) * nbx * 2 + (size_t)blockIdx.x * 2;
      out[0] = 0.0f;
      out[1] = 0.0f;
    }
    return;
  }

  const bool chunks = aligned && y0 - R >= 0 && y0 + kTileH + R <= h && x0 - Q::kPad >= 0 &&
                      x0 + kTileW + Q::kPad <= w;
  // One branch on shift for the whole load: a test per sample cost the
  // narrow scale 0 2% at 1080p.
  if (shift > 0) {
    load_tile<T, R, RE, kNarrow, true>(in, src, bsz, b, h, w, x0, y0, shift, chunks);
  } else {
    load_tile<T, R, RE, kNarrow, false>(in, src, bsz, b, h, w, x0, y0, shift, chunks);
  }
  __syncthreads();

  // Vertical pass: column c (input column x0 - R + c) of output rows g*4 ..
  // g*4+3, from input rows g*4 .. g*4+3+2R of the tile (row o + k for tap
  // k), one quantity at a time (none outside the window).
  constexpr int kVJobs = Q::kInW * (kTileH / kVRows);
#pragma unroll
  for (int n = 0; n < (kVJobs + kTileThreads - 1) / kTileThreads; ++n) {
    const int job = threadIdx.x + n * kTileThreads;
    if (job >= kVJobs || outside) break;
    const int c = job % Q::kInW, g = job / Q::kInW;
    constexpr int kWin = kVRows + 2 * R;
    uint32_t xa[kWin], xd[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      xa[i] = in[(g * kVRows + i) * Q::kRowW + Q::kOff + c];
      xd[i] = in[Q::kIn + (g * kVRows + i) * Q::kRowW + Q::kOff + c];
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      uint32_t p[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        p[i] = q == 0 ? xa[i] : q == 1 ? xd[i] : q == 2 ? xa[i] * xa[i] : q == 3 ? xd[i] * xd[i] : xa[i] * xd[i];
      }
#pragma unroll
      for (int o = 0; o < kVRows; ++o) {
        const auto x = [&p, o](int k) { return p[o + k]; };
        const uint32_t s = q < 2 ? folded_sum<R>(taps.c1, x) : folded_sum<R>(taps.c2, x);
        vert[(q * kTileH + g * kVRows + o) * Q::kVS + c] =
            static_cast<V>(q < 2 ? (s + (1u << 7)) >> 8 : (s + (1u << 11)) >> 12);
      }
    }
  }
  // The next window's vertical pass at the tile's even rows y0 + 2i, columns
  // x0-RE .. x0+31+RE (input row 2i + R - RE + k for tap k).
  if constexpr (RE > 0) {
#pragma unroll
    for (int n = 0; n < (2 * Q::kEmit + kTileThreads - 1) / kTileThreads; ++n) {
      const int idx = threadIdx.x + n * kTileThreads;
      if (idx >= 2 * Q::kEmit) break;
      const int img = idx / Q::kEmit, rem = idx - img * Q::kEmit;
      const int i = rem / Q::kEmitW, e = rem - i * Q::kEmitW;
      const In* p = in + img * Q::kIn + (2 * i + R - RE) * Q::kRowW + Q::kOff + R - RE + e;
      const uint32_t sum = folded_sum<RE>(taps.c1e, [p](int k) { return static_cast<uint32_t>(p[k * Q::kRowW]); });
      emit[idx] = static_cast<V>((sum + (1u << 7)) >> 8);
    }
  }
  __syncthreads();

  // Horizontal pass, moments and map: lane l of the warp takes row l / 4 of
  // its 32x8 sub-tile and that row's eight columns c0 .. c0+7, c0 = 8 (l %
  // 4), one quantity at a time, reading each vertical sample once (output o,
  // tap k: vertical column c0 + o + k).
  const int row = warp * kBy + lane / 4, c0 = kHRun * (lane % 4);
  const int gr = y0 + row;
  float v[2] = {0.0f, 0.0f};
  if (!outside) {
    uint32_t mu[2][kHRun];
    int s[3][kHRun];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      uint32_t x[kHRun + 2 * R];
#pragma unroll
      for (int j = 0; j < kHRun + 2 * R; ++j) x[j] = vert[(q * kTileH + row) * Q::kVS + c0 + j];
#pragma unroll
      for (int o = 0; o < kHRun; ++o) {
        const uint32_t sum = folded_sum<R>(taps.c2, [&x, o](int k) { return x[o + k]; });
        if (q < 2) {
          mu[q][o] = (sum + (1u << 15)) >> 16;
        } else {
          const uint32_t pb = (sum + 8u) >> 4;
          const uint32_t m = q == 2 ? mu[0][o] * mu[0][o] : q == 3 ? mu[1][o] * mu[1][o] : mu[0][o] * mu[1][o];
          const int d = static_cast<int>(pb - m);
          s[q - 2][o] = q < 4 ? max(d, 0) : d;
        }
      }
    }
    // The thread's num and den over its eight owned pixels, in column order
    // (chi <= w: an owned column lies in the plane).
#pragma unroll
    for (int o = 0; o < kHRun; ++o) {
      const int gc = x0 + c0 + o;
      const bool in_plane = gr < h && gc < w;
      if constexpr (kCheck) {
        if (in_plane) {
          const size_t at = (size_t)b * npx + (size_t)gr * w + gc, plane = (size_t)bsz * npx;
          check[at] = s[0][o];
          check[plane + at] = s[1][o];
          check[2 * plane + at] = s[2][o];
          check[3 * plane + at] = static_cast<int>(mu[0][o]);
          check[4 * plane + at] = static_cast<int>(mu[1][o]);
        }
      }
      float nd[2] = {0.0f, 0.0f};
      if (gr < h && gc >= clo && gc < chi) ivif_map(s[0][o], s[1][o], s[2][o], nd);
#pragma unroll
      for (int k = 0; k < 2; ++k) v[k] = o == 0 ? nd[k] : __fadd_rn(v[k], nd[k]);
    }
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
  if (lane == 0 && by < nby) {
    float* out = parts + ((size_t)b * nby + by) * nbx * 2 + (size_t)blockIdx.x * 2;
    out[0] = v[0];
    out[1] = v[1];
  }

  // The next window's horizontal pass at the even columns x0 + 2m of the
  // even rows: next scale pixel (y0/2 + i, x0/2 + m) of both images.
  if constexpr (RE > 0) {
    const int he = (h + 1) / 2, we = (w + 1) / 2;
#pragma unroll
    for (int n = 0; n < 2 * (kTileH / 2) * (kTileW / 2) / kTileThreads; ++n) {
      const int idx = threadIdx.x + n * kTileThreads;
      const int img = idx / ((kTileH / 2) * (kTileW / 2)), i = idx / (kTileW / 2) % (kTileH / 2);
      const int m = idx % (kTileW / 2);
      const int ni = y0 / 2 + i, nj = x0 / 2 + m;
      if (ni >= he || nj >= we) continue;
      const V* p = emit + (img * (kTileH / 2) + i) * Q::kEmitW + 2 * m;
      const uint32_t sum = folded_sum<RE>(taps.c2e, [p](int k) { return static_cast<uint32_t>(p[k]); });
      next[(((size_t)img * bsz + b) * he + ni) * we + nj] = static_cast<uint16_t>((sum + (1u << 19)) >> 20);
    }
  }
}

int vif_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// Allows the instance its dynamic shared memory: once per device
// (per_device.cuh), before the first launch or occupancy query on it.
template <typename T, int R, int RE, bool kNarrow, bool kCheck>
cudaError_t tile_setup() {
  static tm_setup::PerDevice<cudaError_t> setups;
  cudaError_t err = cudaSuccess;
  const cudaError_t* setup = setups.get(&err, [](int) {
    return cudaFuncSetAttribute(integer_vif_kernel<T, R, RE, kNarrow, kCheck>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)ITile<T, R, RE, kNarrow>::kSmemBytes);
  });
  return setup != nullptr ? *setup : err;
}

struct Args {
  const void* in;
  int bsz, h, w, shift, clo, chi;
  const int* coeffs;  // host: C1, C2 of this scale (2R+1 each), then C1, C2 of the next (2RE+1 each)
  float *parts, *sums;
  int sums_pstride;
  uint16_t* next;
  int* check;
  cudaStream_t s;
};

// The folded taps from the full windows at coeffs; false unless every
// window is symmetric.
template <int R, int RE>
bool fold_taps(const int* coeffs, FoldedTaps<R, RE>& t) {
  const int* c1 = coeffs;
  const int* c2 = c1 + 2 * R + 1;
  const int* c1e = c2 + 2 * R + 1;
  const int* c2e = c1e + 2 * RE + 1;
  for (int k = 0; k <= R; ++k) {
    if (c1[k] != c1[2 * R - k] || c2[k] != c2[2 * R - k]) return false;
    t.c1[k] = static_cast<uint32_t>(c1[k]);
    t.c2[k] = static_cast<uint32_t>(c2[k]);
  }
  for (int k = 0; k <= RE; ++k) {
    if (RE > 0 && (c1e[k] != c1e[2 * RE - k] || c2e[k] != c2e[2 * RE - k])) return false;
    t.c1e[k] = RE > 0 ? static_cast<uint32_t>(c1e[k]) : 0u;
    t.c2e[k] = RE > 0 ? static_cast<uint32_t>(c2e[k]) : 0u;
  }
  return true;
}

template <typename T, int R, int RE, bool kNarrow, bool kCheck>
int launch(const Args& a) {
  cudaError_t err = tile_setup<T, R, RE, kNarrow, kCheck>();
  if (err != cudaSuccess) return (int)err;
  FoldedTaps<R, RE> taps;
  if (!fold_taps<R, RE>(a.coeffs, taps)) return (int)cudaErrorInvalidValue;
  const int aligned = reinterpret_cast<uintptr_t>(a.in) % 16 == 0 && ((size_t)a.w * sizeof(T)) % 16 == 0;
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH, a.bsz);
  integer_vif_kernel<T, R, RE, kNarrow, kCheck><<<grid, kTileThreads, ITile<T, R, RE, kNarrow>::kSmemBytes, a.s>>>(
      static_cast<const T*>(a.in), a.bsz, a.h, a.w, a.shift, aligned, a.clo, a.chi, taps, a.parts, a.next, a.check);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_frames_kernel<2><<<a.bsz, kReduceThreads, 0, a.s>>>(a.parts, vif_blocks(a.h, a.w), a.sums,
                                                             a.sums_pstride);
  return (int)cudaGetLastError();
}

template <typename T, int R, int RE, bool kNarrow, bool kCheck>
int attrs(int* out) {
  cudaError_t err = tile_setup<T, R, RE, kNarrow, kCheck>();
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, integer_vif_kernel<T, R, RE, kNarrow, kCheck>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integer_vif_kernel<T, R, RE, kNarrow, kCheck>,
                                                        kTileThreads, ITile<T, R, RE, kNarrow>::kSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)ITile<T, R, RE, kNarrow>::kSmemBytes;
  out[2] = per_sm;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

// The instance of (scale, luma type, width, check), handed to F: scale 0
// reads uint8 (type 0, narrow), uint16 (1) or int32 (2) codes (wide),
// scales 1-3 the uint16 planes scale 0-2 emitted, narrow from uint8 codes;
// only scale 0 pre-rounds.
template <bool kCheck, typename F>
int dispatch(int scale, int type, int narrow, int shift, F&& f) {
  if (scale == 0 ? (narrow != 0) != (type == 0) : type != 1 || shift != 0) return (int)cudaErrorInvalidValue;
  if (scale == 0) {
    switch (type) {
      case 0: return f.template operator()<uint8_t, 8, 4, true, kCheck>();
      case 1: return f.template operator()<uint16_t, 8, 4, false, kCheck>();
      case 2: return f.template operator()<int, 8, 4, false, kCheck>();
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (scale) {
    case 1:
      return narrow ? f.template operator()<uint16_t, 4, 2, true, kCheck>()
                    : f.template operator()<uint16_t, 4, 2, false, kCheck>();
    case 2:
      return narrow ? f.template operator()<uint16_t, 2, 1, true, kCheck>()
                    : f.template operator()<uint16_t, 2, 1, false, kCheck>();
    case 3:
      return narrow ? f.template operator()<uint16_t, 1, 0, true, kCheck>()
                    : f.template operator()<uint16_t, 1, 0, false, kCheck>();
    default: return (int)cudaErrorInvalidValue;
  }
}

struct Launch {
  const Args& a;
  template <typename T, int R, int RE, bool kNarrow, bool kCheck>
  int operator()() const { return launch<T, R, RE, kNarrow, kCheck>(a); }
};

struct Attrs {
  int* out;
  template <typename T, int R, int RE, bool kNarrow, bool kCheck>
  int operator()() const { return attrs<T, R, RE, kNarrow, kCheck>(out); }
};

}  // namespace

extern "C" {

// Number of 32x8-tile partials tm_integer_vif_level writes per frame of an
// h x w scale: the caller sizes `parts` as B*nblk*2 floats.
int tm_integer_vif_blocks(int h, int w) { return vif_blocks(h, w); }

// What integer_vif_kernel takes at VIF scale `scale` (0-3) on luma of
// `type` (0 uint8, 1 uint16, 2 int32; scales 1-3: 1), narrow (uint8 codes
// and the scales after them) or wide, with the check stores
// (check != 0) or without: out[0] registers per thread, out[1] dynamic
// shared memory per block in bytes, out[2] resident blocks per SM, out[3]
// local memory per thread in bytes (spills).
int tm_integer_vif_attrs(int scale, int type, int narrow, int check, int* out) {
  const Attrs f{out};
  return check ? dispatch<true>(scale, type, narrow, 0, f) : dispatch<false>(scale, type, narrow, 0, f);
}

// Fixed-point VIF scale `scale` (0-3) of the pair `in` (2, B, h, w) of luma
// codes of `type` -> sums[b * sums_pstride + {0, 1}] = (num, den) over the
// columns [clo, chi) (0 <= clo <= chi <= w; 0 and w: the whole scale; clo
// == chi: zeros; with check non-null only the whole scale).  shift:
// the pre-rounding shift (depth - 8 at scale 0 above 8 bits, else 0).
// narrow: the luma were uint8 codes (every scale's samples < 2^8; the
// caller passes the same at every scale).  coeffs (host int32):
// C1, C2 of this scale's window, then C1, C2 of the next scale's (scales
// 0-2), each symmetric.  With scale < 3 it also writes `next` (2, B,
// ceil(h/2), ceil(w/2)) uint16, the next scale's input; with check non-null
// the moments (5, B, h, w) int32 s11, s22, s12, mu1, mu2.  parts holds
// B*tm_integer_vif_blocks(h, w)*2 floats, the only scratch.
int tm_integer_vif_level(const void* in, int type, int narrow, int bsz, int h, int w, int scale, int shift,
                         int clo, int chi, const int* coeffs, float* parts, float* sums, int sums_pstride,
                         uint16_t* next, int* check, void* stream) {
  if (clo < 0 || clo > chi || chi > w || (check != nullptr && (clo != 0 || chi != w))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{in, bsz, h, w, shift, clo, chi, coeffs, parts, sums, sums_pstride, next, check,
               static_cast<cudaStream_t>(stream)};
  const Launch f{a};
  return check != nullptr ? dispatch<true>(scale, type, narrow, shift, f)
                          : dispatch<false>(scale, type, narrow, shift, f);
}

}  // extern "C"
