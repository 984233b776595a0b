// XPSNR block statistics on Hopper (sm_90a): per 16x16 block of each frame,
// the SSE against the distorted frame, the sum of |3x3 highpass| of the
// reference (edge-replicated borders) and the sum of |reference - previous
// reference|, as three uint32 grids (B, ceil(h/16), ceil(w/16)).  Built and
// bound like the other sources (plain C entry point, caller's stream,
// returns cudaGetLastError()).
//
// Replaces the JAX package's xpsnr_block_stats_pallas
// (turbo_metrics_tpu/ops/pallas/xpsnr.py:197).  The TPU kernel splits the
// highpass into 16x - [1,2,1]x[1,2,1], keeps every value exact in f32 with a
// hi/lo split of the SSE, and folds columns with a one-hot matmul on the
// MXU; here the integer units do the work directly: err^2 in uint32, the
// highpass in int32, and uint32 sums that wrap mod 2^32 exactly as the
// reference's uint32 grids do.  Integer addition mod 2^32 is associative, so
// the result does not depend on the order of the reduction (no atomics are
// used either way).
//
// What bounds it on this card: device-memory traffic (its bound: per pixel
// one reference, one distorted and one previous-reference sample, u8 or
// u16, or int32 luma codes of RGB sources; 24 bytes out per 256 pixels),
// and in practice the latency of each warp's walk down its 16 rows: at
// 1080p u8 B=8 the grid is one wave (544 blocks of four warps, 5 per SM),
// so the kernel lasts about as long as one warp's row steps.  What the
// design does about it (after the motion kernel, motion.cu):
//   * 16-byte accesses: a lane owns one chunk of 16 bytes of a reference row
//     (16 u8, 8 u16 or 4 int32 samples) and the distorted and previous
//     samples of the same columns (the distorted chunk sized to the
//     reference's sample count), and walks down the 16 rows of its XPSNR
//     block row with the rows above and below in a three-row register
//     window, the next row's loads issued before a row is summed.  At u8 a
//     lane's chunk is one block column, so a lane sums its block alone; at
//     u16 two lanes and at int32 four add theirs by shuffles.  Chunks that
//     are not whole, aligned 16 bytes inside the row take one load per
//     sample (columns past the row's end clamped to it, their terms masked
//     out of the sums);
//   * the highpass takes its left and right neighbours from the
//     neighbouring lanes by warp shuffles: a warp loads 32 chunks of a row
//     and sums the 30 in the middle (28 at int32, whole blocks); segments of
//     the row overlap by those chunks.  At the row's first column and after
//     a chunk that ends the row the replicated neighbour is the lane's own;
//   * at u8 the integer dot products of the card do the arithmetic four
//     samples at a time: each output's highpass is three dp4a (one per row,
//     with the row's bytes shifted into place by byte permutes), and, where
//     the distorted stream is u8 at the same depth, |x - y| of four samples
//     is one vabsdiff4 and its square sum one dp4a;
//   * a thread block's four warps take four consecutive block rows of one
//     segment, so the rows their windows share come from L1.
// Measured on an H100 (1080p u8 B=8, device time) and not kept: loads two
// or three rows ahead (108-134 registers, four or fewer blocks per SM, two
// waves) 0.048 and 0.044 ms, two rows ahead with registers capped for five
// blocks per SM (spills) 0.031 ms, two warps per block with loads two rows
// ahead 0.046 ms, against this design's 0.028 ms; at u8 the one-sample-per-
// register walk of the wider types (sums_wide<uint8_t>: 128 registers, four
// blocks per SM, two waves) 0.070 ms, and the dp4a path without vabsdiff4
// for the u8/u8 SSE 0.033 ms, against 0.026 ms.
// The previous frame of frame b is reference frame b-1 of the same batch
// (frame 0 reads the plane carried over from the previous batch), so no
// third batch of planes is uploaded; or, where the caller gives one, frame
// b's own previous plane (the JAX package's y_prev, a (B, h, w) batch of
// planes read at a batch stride), in the same one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;    // XPSNR block side
constexpr int kWarps = 4;     // warps per thread block, one block row each
constexpr int kMaxSeg = 30;   // chunks a warp sums per row at most (lanes 1..30)
constexpr unsigned kAll = 0xffffffffu;

// Per reference type TR: V samples per lane, L lanes per XPSNR block column,
// kSeg chunks a warp sums per row (whole block columns).
template <typename TR>
struct Geometry {
  static constexpr int V = 16 / (int)sizeof(TR);
  static constexpr int L = kBlock / V;
  static constexpr int kSeg = kMaxSeg - kMaxSeg % L;
};

// N samples of type T, as samples or as raw 32-bit words.
template <typename T, int N>
union Samples {
  T s[N];
  uint32_t u[N * sizeof(T) / 4];
};

// The N samples of a row at columns c .. c+N-1 (0 <= c < w): 16-byte loads
// (8 or 4 bytes where N samples take fewer) where they lie inside the row
// and are aligned, else one load per sample at columns clamped to the row.
template <typename T, int N>
__device__ __forceinline__ void load_samples(const T* __restrict__ row, int c, int w,
                                             Samples<T, N>& v) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kAlign = kBytes < 16 ? kBytes : 16;
  const T* p = row + c;
  if (c + N <= w && reinterpret_cast<uintptr_t>(p) % kAlign == 0) {
    if constexpr (kBytes == 4) {
      v.u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (kBytes == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      v.u[0] = q.x;
      v.u[1] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
        v.u[4 * k] = q.x;
        v.u[4 * k + 1] = q.y;
        v.u[4 * k + 2] = q.z;
        v.u[4 * k + 3] = q.w;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v.s[j] = __ldg(row + min(c + j, w - 1));
}

// d = c + sum_k a.u8[k] * b.s8[k]: unsigned samples, signed taps.
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Highpass taps as signed bytes for dp4a: a row above or below the output
// (-1, -2, -1) and the output's own row (-2, 12, -2), centred on byte 1 (P0)
// or byte 2 (P1) of a word.
constexpr uint32_t kNbr0 = 0x00fffeffu, kNbr1 = 0xfffeff00u;
constexpr uint32_t kMid0 = 0x00fe0cfeu, kMid1 = 0xfe0cfe00u;

// One u8 reference row of a lane's 16 columns as words w[k] = samples
// 4k .. 4k+3, and the same bytes shifted for the highpass: s[k] = samples
// 4k-1 .. 4k+2 and t[k] = samples 4k+2 .. 4k+5.
struct RowU8 {
  uint32_t w[4], s[4], t[4];
};

// Fills a row's shifted words; every lane of the warp calls it (the
// neighbouring samples 4k-1 at k = 0 and 16 come from the lanes on either
// side, or from this lane's own samples at the row's first column and after
// a chunk that ends the row).
__device__ __forceinline__ void shift_row(RowU8& r, int c, int w) {
  uint32_t lw = __shfl_up_sync(kAll, r.w[3], 1);
  uint32_t rw = __shfl_down_sync(kAll, r.w[0], 1);
  if (c == 0) lw = r.w[0] << 24;       // sample -1 = sample 0
  if (c + 16 == w) rw = r.w[3] >> 24;  // sample 16 = sample 15
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.s[k] = __byte_perm(k == 0 ? lw : r.w[k - 1], r.w[k], 0x6543);
    r.t[k] = __byte_perm(r.w[k], k == 3 ? rw : r.w[k + 1], 0x5432);
  }
}

// The highpass of sample j of the middle row m, rows u above and d below.
__device__ __forceinline__ int highpass_u8(const RowU8& u, const RowU8& m, const RowU8& d, int j) {
  const int k = j >> 2;
  switch (j & 3) {
    case 0: return dp4a_us(m.s[k], kMid0, dp4a_us(u.s[k], kNbr0, dp4a_us(d.s[k], kNbr0, 0)));
    case 1: return dp4a_us(m.w[k], kMid0, dp4a_us(u.w[k], kNbr0, dp4a_us(d.w[k], kNbr0, 0)));
    case 2: return dp4a_us(m.w[k], kMid1, dp4a_us(u.w[k], kNbr1, dp4a_us(d.w[k], kNbr1, 0)));
    default: return dp4a_us(m.t[k], kMid0, dp4a_us(u.t[k], kNbr0, dp4a_us(d.t[k], kNbr0, 0)));
  }
}

// The distorted sample aligned to the reference's depth.
__device__ __forceinline__ int32_t to_ref_depth(int32_t d, int ls, int rs) { return (d << ls) >> rs; }

// The edge-replicated row index.
__device__ __forceinline__ int clamp_row(int r, int h) { return min(max(r, 0), h - 1); }

// What one output row r takes from device memory: the reference row below
// it (r + 1, edge-replicated), the distorted row and the previous frame's
// row, V samples each.
template <typename TR, typename TD, int V>
struct RowLoads {
  Samples<TR, V> below, prev;
  Samples<TD, V> dis;
};

// Loads row r's samples (zeros where the lane loads nothing or r >= h).
template <typename TR, typename TD, int V>
__device__ __forceinline__ void fetch(RowLoads<TR, TD, V>& q, const TR* __restrict__ r_img,
                                      const TD* __restrict__ d_img, const TR* __restrict__ p_img,
                                      int h, int w, int r, int c, bool loads) {
#pragma unroll
  for (int k = 0; k < V * (int)sizeof(TR) / 4; ++k) q.below.u[k] = q.prev.u[k] = 0u;
#pragma unroll
  for (int k = 0; k < V * (int)sizeof(TD) / 4; ++k) q.dis.u[k] = 0u;
  if (loads && r < h) {
    load_samples(r_img + (size_t)min(r + 1, h - 1) * w, c, w, q.below);
    load_samples(d_img + (size_t)r * w, c, w, q.dis);
    load_samples(p_img + (size_t)r * w, c, w, q.prev);
  }
}

// One lane's sums over its block row: u8 reference.  kBytes: the distorted
// stream is u8 at the reference's depth (vabsdiff4 and dp4a for the SSE).
// The next row's loads are in flight while a row is summed.
template <typename TD, bool kBytes>
__device__ __forceinline__ void sums_u8(const uint8_t* __restrict__ r_img, const TD* __restrict__ d_img,
                                        const uint8_t* __restrict__ p_img, int h, int w, int r0, int c,
                                        bool loads, int ls, int rs, uint32_t (&acc)[3]) {
  const int nv = w - c;  // samples of the chunk inside the row (whole: >= 16)
  RowU8 up, mid, dn;
  Samples<uint8_t, 16> ld;
  ld.u[0] = ld.u[1] = ld.u[2] = ld.u[3] = 0u;
  if (loads) load_samples(r_img + (size_t)clamp_row(r0 - 1, h) * w, c, w, ld);
#pragma unroll
  for (int k = 0; k < 4; ++k) up.w[k] = ld.u[k];
  if (loads) load_samples(r_img + (size_t)r0 * w, c, w, ld);
#pragma unroll
  for (int k = 0; k < 4; ++k) mid.w[k] = ld.u[k];
  RowLoads<uint8_t, TD, 16> next;
  fetch(next, r_img, d_img, p_img, h, w, r0, c, loads);
  shift_row(up, c, w);
  shift_row(mid, c, w);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    const int r = r0 + i;
    if (r >= h) break;  // uniform over the warp
    const RowLoads<uint8_t, TD, 16> in = next;
    if (i + 1 < kBlock) fetch(next, r_img, d_img, p_img, h, w, r + 1, c, loads);
#pragma unroll
    for (int k = 0; k < 4; ++k) dn.w[k] = in.below.u[k];
    shift_row(dn, c, w);
    int hp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) hp[j] = highpass_u8(up, mid, dn, j);
    if (nv >= 16) {
#pragma unroll
      for (int j = 0; j < 16; j += 2) acc[1] += (uint32_t)abs(hp[j]) + (uint32_t)abs(hp[j + 1]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[2] = __dp4a(__vabsdiffu4(mid.w[k], in.prev.u[k]), 0x01010101u, acc[2]);
        if constexpr (kBytes) {
          const uint32_t e = __vabsdiffu4(mid.w[k], in.dis.u[k]);
          acc[0] = __dp4a(e, e, acc[0]);
        }
      }
      if constexpr (!kBytes) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t e = (uint32_t)((int32_t)((mid.w[j >> 2] >> (8 * (j & 3))) & 0xffu) -
                                        to_ref_depth((int32_t)in.dis.s[j], ls, rs));
          acc[0] += e * e;
        }
      }
    } else {  // the chunk that the row's end cuts: its columns inside the row
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < nv) {
          const int32_t x = (int32_t)((mid.w[j >> 2] >> (8 * (j & 3))) & 0xffu);
          const uint32_t e = (uint32_t)(x - to_ref_depth((int32_t)in.dis.s[j], ls, rs));
          acc[0] += e * e;
          acc[1] += (uint32_t)abs(hp[j]);
          acc[2] += (uint32_t)abs(x - (int32_t)in.prev.s[j]);
        }
      }
    }
    up = mid;
    mid = dn;
  }
}

// One lane's sums over its block row: u16 or int32 reference, one sample
// per register; loads a row ahead as sums_u8.
template <typename TR, typename TD>
__device__ __forceinline__ void sums_wide(const TR* __restrict__ r_img, const TD* __restrict__ d_img,
                                          const TR* __restrict__ p_img, int h, int w, int r0, int c,
                                          bool loads, int ls, int rs, uint32_t (&acc)[3]) {
  constexpr int V = Geometry<TR>::V;
  const int nv = w - c;
  int32_t up[V], mid[V], dn[V];
  Samples<TR, V> ld;
#pragma unroll
  for (int k = 0; k < 4; ++k) ld.u[k] = 0u;
  if (loads) load_samples(r_img + (size_t)clamp_row(r0 - 1, h) * w, c, w, ld);
#pragma unroll
  for (int j = 0; j < V; ++j) up[j] = (int32_t)ld.s[j];
  if (loads) load_samples(r_img + (size_t)r0 * w, c, w, ld);
#pragma unroll
  for (int j = 0; j < V; ++j) mid[j] = (int32_t)ld.s[j];
  RowLoads<TR, TD, V> next;
  fetch(next, r_img, d_img, p_img, h, w, r0, c, loads);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    const int r = r0 + i;
    if (r >= h) break;  // uniform over the warp
    const RowLoads<TR, TD, V> in = next;
    if (i + 1 < kBlock) fetch(next, r_img, d_img, p_img, h, w, r + 1, c, loads);
#pragma unroll
    for (int j = 0; j < V; ++j) dn[j] = (int32_t)in.below.s[j];
    // 16x - [1,2,1] x [1,2,1]: v the vertical [1,2,1] of each column, its
    // outer columns from the lanes on either side (or replicated).
    // (In uint32: the arithmetic wraps mod 2^32 as the reference's int32.)
    uint32_t v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (uint32_t)up[j] + (uint32_t)dn[j] + 2u * (uint32_t)mid[j];
    uint32_t vl = __shfl_up_sync(kAll, v[V - 1], 1);
    uint32_t vr = __shfl_down_sync(kAll, v[0], 1);
    if (c == 0) vl = v[0];
    if (c + V == w) vr = v[V - 1];
    uint32_t e[3][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t hp = 16u * (uint32_t)mid[j] - ((j == 0 ? vl : v[j - 1]) + (j == V - 1 ? vr : v[j + 1]) + 2u * v[j]);
      const uint32_t err = (uint32_t)mid[j] - (uint32_t)to_ref_depth((int32_t)in.dis.s[j], ls, rs);
      e[0][j] = err * err;
      e[1][j] = (uint32_t)abs((int32_t)hp);
      e[2][j] = (uint32_t)abs((int32_t)((uint32_t)mid[j] - (uint32_t)in.prev.s[j]));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (nv >= V || j < nv) {
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[q] += e[q][j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      up[j] = mid[j];
      mid[j] = dn[j];
    }
  }
}

// grid: (ceil(ceil(w / V) / kSeg), ceil(ceil(h / 16) / kWarps), B), block:
// kWarps * 32 threads; warp g of block (x, y) takes block row y * kWarps + g
// of segment x.
template <typename TR, typename TD, bool kBytes>
__global__ void __launch_bounds__(kWarps * 32)
xpsnr_kernel(const TR* __restrict__ ref, const TD* __restrict__ dis, const TR* __restrict__ prev0,
             const TR* __restrict__ prev, int prev_bstride, int h, int w, int dis_shift,
             int64_t* __restrict__ out) {
  using G = Geometry<TR>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int by = blockIdx.y * kWarps + warp;
  const int r0 = by * kBlock;
  if (r0 >= h) return;  // the whole warp
  const int c = ((int)blockIdx.x * G::kSeg + lane - 1) * G::V;  // this lane's first column
  const bool loads = lane <= G::kSeg + 1 && c >= 0 && c < w;
  const int b = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const TR* r_img = ref + b * npx;
  const TD* d_img = dis + b * npx;
  const TR* p_img = prev != nullptr ? prev + (size_t)b * prev_bstride : b == 0 ? prev0 : ref + (b - 1) * npx;
  const int ls = max(dis_shift, 0), rs = max(-dis_shift, 0);
  uint32_t acc[3] = {0u, 0u, 0u};
  if constexpr (sizeof(TR) == 1) {
    sums_u8<TD, kBytes>(r_img, d_img, p_img, h, w, r0, c, loads, ls, rs, acc);
  } else {
    sums_wide<TR, TD>(r_img, d_img, p_img, h, w, r0, c, loads, ls, rs, acc);
  }
  // Lanes 1..kSeg whose chunk starts inside the row sum; the others only fed
  // their neighbours.
  const bool sums = lane >= 1 && lane <= G::kSeg && c < w;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (!sums) acc[q] = 0u;
#pragma unroll
    for (int o = 1; o < G::L; o <<= 1) acc[q] += __shfl_down_sync(kAll, acc[q], o);
  }
  if (sums && (lane - 1) % G::L == 0) {
    const int hb = (h + kBlock - 1) / kBlock, wb = (w + kBlock - 1) / kBlock;
    const size_t at = ((size_t)b * hb + by) * wb + c / kBlock;
    const size_t plane = (size_t)gridDim.z * hb * wb;
#pragma unroll
    for (int q = 0; q < 3; ++q) out[q * plane + at] = (int64_t)acc[q];
  }
}

// XPSNR's weighted SSE of each frame, from the three grids above: per block
// msact = max(1 + sact / 256 + 2 tact / 256, 2^(depth - 2)) and the term
// (1 / msact) * sse, summed over the frame in f64.  The arithmetic of
// ops/xpsnr_ops.py xpsnr_weights for frames above 640x480 (those at most
// that size smooth the weights over their neighbours, a walk in block order
// that stays on the host), each operation rounded on its own (no FMA
// contraction), so every term holds the host's bits and only the order of
// the sum differs: the reference's limit of 1e-9 dB allows that order.
//
// Replaces no TPU kernel: the JAX package weighs the grids on the host.  What
// bounds it on this card: bytes, 24 per block (1.37 MB at 1080p B=7, 3.1 MB at
// 4K B=4, ~1 us at 3.35 TB/s), against a launch's latency of a few us.  One
// thread block per frame sums in a fixed order (each thread its strided
// blocks in turn, four loads in flight, then a tree over the threads), so
// two calls give the same bits and a frame's sum does not depend on the
// batch it is in.
constexpr int kWsseThreads = 1024;
constexpr int kWsseUnroll = 4;

__device__ __forceinline__ double wsse_term(int64_t sse, int64_t sact, int64_t tact, double floor) {
  const double m = fmax(__dadd_rn(__dadd_rn(1.0, __ddiv_rn((double)sact, 256.0)),
                                  __ddiv_rn(__dmul_rn(2.0, (double)tact), 256.0)),
                        floor);
  return __dmul_rn(__ddiv_rn(1.0, m), (double)sse);
}

// grid: (B), block: kWsseThreads; frame b's grids are blocks int64 values at
// b * blocks of each.
__global__ void __launch_bounds__(kWsseThreads)
xpsnr_wsse_kernel(const int64_t* __restrict__ sse, const int64_t* __restrict__ sact,
                  const int64_t* __restrict__ tact, int blocks, double floor, double* __restrict__ out) {
  __shared__ double red[kWsseThreads];
  const size_t base = (size_t)blockIdx.x * blocks;
  const int tid = threadIdx.x;
  double acc = 0.0;
  int i = tid;
  for (; i + (kWsseUnroll - 1) * kWsseThreads < blocks; i += kWsseUnroll * kWsseThreads) {
    int64_t s[kWsseUnroll], a[kWsseUnroll], t[kWsseUnroll];
#pragma unroll
    for (int u = 0; u < kWsseUnroll; ++u) {
      const size_t at = base + i + u * kWsseThreads;
      s[u] = sse[at];
      a[u] = sact[at];
      t[u] = tact[at];
    }
#pragma unroll
    for (int u = 0; u < kWsseUnroll; ++u) acc = __dadd_rn(acc, wsse_term(s[u], a[u], t[u], floor));
  }
  for (; i < blocks; i += kWsseThreads) acc = __dadd_rn(acc, wsse_term(sse[base + i], sact[base + i], tact[base + i], floor));
  red[tid] = acc;
  __syncthreads();
  for (int stride = kWsseThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = __dadd_rn(red[tid], red[tid + stride]);
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = red[0];
}

// The instance for the reference and distorted types (0 u8, 1 u16, 2 int32)
// and the shift, with its geometry; null for an unknown type.
template <typename TR>
void* pick_dis(int dis_type, int dis_shift) {
  switch (dis_type) {
    case 0:
      if constexpr (sizeof(TR) == 1) {
        if (dis_shift == 0) return reinterpret_cast<void*>(xpsnr_kernel<TR, uint8_t, true>);
      }
      return reinterpret_cast<void*>(xpsnr_kernel<TR, uint8_t, false>);
    case 1: return reinterpret_cast<void*>(xpsnr_kernel<TR, uint16_t, false>);
    case 2: return reinterpret_cast<void*>(xpsnr_kernel<TR, int32_t, false>);
    default: return nullptr;
  }
}

// (kernel, samples per lane, chunks summed per warp row) of a combination.
struct Pick {
  void* fn;
  int v, seg;
};

Pick pick(int ref_type, int dis_type, int dis_shift) {
  switch (ref_type) {
    case 0: return {pick_dis<uint8_t>(dis_type, dis_shift), Geometry<uint8_t>::V, Geometry<uint8_t>::kSeg};
    case 1: return {pick_dis<uint16_t>(dis_type, dis_shift), Geometry<uint16_t>::V, Geometry<uint16_t>::kSeg};
    case 2: return {pick_dis<int32_t>(dis_type, dis_shift), Geometry<int32_t>::V, Geometry<int32_t>::kSeg};
    default: return {nullptr, 0, 0};
  }
}

}  // namespace

extern "C" {

// ref (images, h, w) and prev0 (h, w) of one type, dis (images, h, w) of
// another; types: 0 u8, 1 u16, 2 int32.  The previous plane of image b is
// prev + b * prev_bstride (h x w, ref's type) where prev is non-null, else
// image b - 1 of ref, prev0 for image 0 (prev0 then unused where prev is
// given).  The distorted samples are shifted left by dis_shift bits (right
// when negative) before the comparison.  out:
// (3, images, ceil(h/16), ceil(w/16)) int64, the SSE, spatial and temporal
// activity grids (uint32 values, as torch holds them).
int tm_xpsnr_block_stats(const void* ref, int ref_type, const void* dis, int dis_type,
                         const void* prev0, const void* prev, int prev_bstride, int images, int h,
                         int w, int dis_shift, int64_t* out, void* stream) {
  const Pick k = pick(ref_type, dis_type, dis_shift);
  if (k.fn == nullptr || images < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (prev == nullptr ? prev0 == nullptr : (long long)prev_bstride < (long long)h * w) return (int)cudaErrorInvalidValue;
  const int chunks = (w + k.v - 1) / k.v, hb = (h + kBlock - 1) / kBlock;
  const dim3 grid((chunks + k.seg - 1) / k.seg, (hb + kWarps - 1) / kWarps, images);
  void* args[] = {&ref, &dis, &prev0, &prev, &prev_bstride, &h, &w, &dis_shift, &out};
  const cudaError_t err = cudaLaunchKernel(k.fn, grid, dim3(kWarps * 32), args, 0,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// sse, sact, tact: (images, blocks) int64 grids (tm_xpsnr_block_stats' three,
// or any such), depth 2..16 bits of the reference.  out: (images) f64, each
// frame's weighted SSE (xpsnr_wsse_kernel).
int tm_xpsnr_wsse(const int64_t* sse, const int64_t* sact, const int64_t* tact, int images, int blocks,
                  int depth, double* out, void* stream) {
  if (images < 1 || blocks < 1 || depth < 2 || depth > 16) return (int)cudaErrorInvalidValue;
  const double floor = (double)(1 << (depth - 2));
  xpsnr_wsse_kernel<<<images, kWsseThreads, 0, static_cast<cudaStream_t>(stream)>>>(sse, sact, tact, blocks,
                                                                                     floor, out);
  return (int)cudaGetLastError();
}

// What the instance for the reference and distorted types (0 u8, 1 u16, 2
// int32) and a shift takes on this card: out[0] registers per thread, out[1]
// static shared memory per block in bytes, out[2] resident blocks per SM,
// out[3] local memory per thread in bytes (spills).
int tm_xpsnr_attributes(int ref_type, int dis_type, int dis_shift, int* out) {
  const Pick k = pick(ref_type, dis_type, dis_shift);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k.fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
