// VMAF motion on Hopper (sm_90a): the exact integer 5-tap blur of a batch of
// luma planes (taps 3571/16004/26386/16004/3571, a vertical pass rounded
// >> depth, a horizontal pass rounded >> 16, uint16 out) and, per row, the
// SAD of each blurred frame against the previous one.  Built and bound like
// the other sources (plain C entry points, caller's stream, each returns
// cudaGetLastError()).
//
// Replaces two TPU kernels of the JAX package:
//   * turbo_metrics_tpu/ops/pallas/motion.py motion_stats_pallas (l.180):
//     blur + row SADs = tm_motion_stats, once per batch;
//   * turbo_metrics_tpu/ops/pallas/motion.py integer_blur_pallas (l.236):
//     the blur alone = tm_integer_blur, for a stream's first frame.
// The TPU kernel splits every sample into hi/lo bytes so that the MXU's
// products stay exact; here the integer units do the work directly in
// uint32, which holds every step exactly: the vertical sum reaches at most
// 65535 * 65536 + 2^15 < 2^32 at 16 bits (int32 would not), and the
// arithmetic wraps mod 2^32 exactly as the reference's uint32 arithmetic.
// Being a ring, mod-2^32 arithmetic lets the symmetric taps be added before
// they are multiplied (3571 (a + e) + 16004 (b + d) + 26386 c): the same
// bits in three multiplies instead of five.
//
// Borders are the reference's asymmetric mirror: x[-1] = x[1], x[-2] = x[2]
// at the low edge, x[n] = x[n-1], x[n+1] = x[n-2] at the high edge (frames
// of at least 3x3).  Mirroring a luma column mirrors its vertical sum, so
// the horizontal pass needs no mirror of its own: a chunk that reaches past
// an edge loads its samples at their mirrored columns.
//
// Where the previous blurred frame comes from: frame b's previous frame is
// frame b-1 of the same batch, and frame 0's is the plane the caller carries
// over from the previous batch.  A warp walks its rows through the frames
// in order and keeps its own blurred output of frame b-1 in registers (two
// rows of one chunk, packed), so each frame is blurred once.  In place of
// that plane the caller may give every frame its own previous blurred plane
// (`prev`, frame b's at prev + b * prev_bstride: the JAX package's
// per-frame `prev_blurred`, which ops/vmaf_motion.py motion_stats takes):
// each frame then loads its own rows, as frame 0 loads the carried plane's,
// and what the warp keeps of frame b-1 goes unread.
//
// What bounds it on this card: device-memory traffic and integer issue about
// evenly.  Per pixel it reads one luma sample (u8, u16, or int32 luma codes
// of RGB sources) and writes one uint16, against ~23 integer instructions
// of the blur and SAD.  What the design does about it:
//   * 16-byte accesses: a lane owns one chunk of 16 bytes of luma (16 u8,
//     8 u16 or 4 int32 samples) of a row and holds the six rows its two
//     output rows need in registers as raw chunks, so the vertical pass never
//     touches shared memory; the uint16 results leave 16 (int32: 8) bytes at
//     a time, packed two per word as they are computed (and kept so for the
//     SAD).  Chunks that are not whole, aligned 16 bytes inside the row (rows
//     whose width is not a multiple of the chunk, a base that is not
//     aligned) take one load or store per sample, at the mirrored columns;
//   * the horizontal pass takes its two neighbours on each side from the
//     neighbouring lanes by warp shuffles: a warp loads 32 chunks of a row
//     and writes the 30 in the middle (lanes 1-30; lanes 0 and 31 only feed
//     their neighbours); segments of the row overlap by those two chunks.
//     At the row's first column, and after a chunk that ends the row, the
//     mirrored halo is taken from the lane's own columns, so no lane loads
//     sample by sample where the width is a multiple of the chunk;
//   * a block's four warps take consecutive row pairs of one segment, so the
//     rows their windows share are read from L1; a grid of segments x row
//     bands puts 540 blocks on the card at 1080p u8 whatever the batch (one
//     frame, #17, too);
//   * the row sums of the columns [clo, chi) (0 and w: all of them; a
//     column strip of a frame cut with a halo, parallel/mesh.py
//     spatial_sharding, sums only the columns it owns and still writes
//     every blurred column it holds): each warp adds its segment's SADs of
//     a row (shuffles)
//     into the low 32-bit word of the row's int64, zeroed first
//     (cudaMemsetAsync), by atomicAdd: uint32 sums wrap mod 2^32 exactly as
//     the reference's, in any order, so the results stay deterministic.
// Measured on an H100 (1080p u8 B=8, device time) and not kept: the grid
// spanning the frames with frame b-1's blur recomputed beside frame b's
// (twice the integer work) 0.1075 ms; the next frame's rows loaded into
// registers while this frame computes, four rows per warp, or eight warps
// per block: no faster than this design's 0.042 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // warps per block, stacked down the rows
constexpr int kRows = 2;        // output rows per warp
constexpr int kWin = kRows + 4;  // luma rows a warp holds per frame
constexpr int kSegChunks = 30;  // chunks a warp writes per row (lanes 1..30)
constexpr uint32_t kF0 = 3571u, kF1 = 16004u, kF2 = 26386u;

// The asymmetric mirror of i, clamped to [-2, n+1] first (columns and rows
// past that feed only pixels outside the frame), n >= 3.
__device__ __forceinline__ int mirror(int i, int n) {
  i = abs(min(max(i, -2), n + 1));
  return i < n ? i : 2 * n - 1 - i;
}

// One 16-byte chunk of samples of type T, as raw words or as samples.
template <typename T>
union Chunk {
  static constexpr int V = 16 / sizeof(T);
  uint4 raw;
  T s[V];
};

// Word k of a raw chunk (k known at compile time: no local memory).
__device__ __forceinline__ uint32_t word(const uint4& raw, int k) {
  return k == 0 ? raw.x : k == 1 ? raw.y : k == 2 ? raw.z : raw.w;
}

// Sample j of a raw chunk as uint32 (int32 codes wrap as the reference's
// uint32 cast does).
template <typename T>
__device__ __forceinline__ uint32_t sample(const uint4& raw, int j) {
  if constexpr (sizeof(T) == 1) {
    return __byte_perm(word(raw, j >> 2), 0u, 0x4440u | (j & 3));  // one byte, zero-extended
  } else if constexpr (sizeof(T) == 2) {
    return __byte_perm(word(raw, j >> 1), 0u, (j & 1) ? 0x4432u : 0x4410u);
  } else {
    return word(raw, j);
  }
}

// The chunk of mirrored row `row` (a pointer to it) at columns c .. c+V-1
// (c a multiple of V): one 16-byte load where it lies inside the row and is
// aligned; nothing where the horizontal pass takes no sample of it (wholly
// left of the row, from column w+2 on, or from column w where the chunk
// before ends the row: horizontal() mirrors those halos itself); else one
// load per sample at its mirrored column (rows whose width is not a
// multiple of V, and unaligned rows).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c, int w) {
  constexpr int V = Chunk<T>::V;
  if (c >= 0 && c + V <= w && reinterpret_cast<uintptr_t>(row + c) % 16 == 0) {
    return __ldg(reinterpret_cast<const uint4*>(row + c));
  }
  if (c + V <= 0 || c >= w + 2 || c == w) return make_uint4(0u, 0u, 0u, 0u);
  Chunk<T> ch;
#pragma unroll
  for (int j = 0; j < V; ++j) ch.s[j] = __ldg(row + mirror(c + j, w));
  return ch.raw;
}

// The vertical pass of the chunk at output row i of the window, whose rows
// i .. i+4 are the rows r-2 .. r+2.
template <typename T>
__device__ __forceinline__ void vertical(const uint4 (&win)[kWin], int i, uint32_t half, int depth,
                                         uint32_t (&vt)[Chunk<T>::V]) {
#pragma unroll
  for (int j = 0; j < Chunk<T>::V; ++j) {
    const uint32_t acc = kF0 * (sample<T>(win[i], j) + sample<T>(win[i + 4], j)) +
                         kF1 * (sample<T>(win[i + 1], j) + sample<T>(win[i + 3], j)) +
                         kF2 * sample<T>(win[i + 2], j);
    vt[j] = (acc + half) >> depth;
  }
}

// The horizontal pass of a lane's V columns c .. c+V-1, packed two uint16
// results per word (column 2k in the low half); the two columns on each
// side come from the neighbouring lanes (every lane of the warp calls it),
// or, at the row's first column and after a chunk that ends the row, from
// this lane's own columns by the mirror.
template <int V>
__device__ __forceinline__ void horizontal(const uint32_t (&vt)[V], int c, int w,
                                           uint32_t (&out)[V / 2]) {
  uint32_t x[V + 4];
  x[0] = __shfl_up_sync(0xffffffffu, vt[V - 2], 1);
  x[1] = __shfl_up_sync(0xffffffffu, vt[V - 1], 1);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j + 2] = vt[j];
  x[V + 2] = __shfl_down_sync(0xffffffffu, vt[0], 1);
  x[V + 3] = __shfl_down_sync(0xffffffffu, vt[1], 1);
  if (c == 0) {  // x[-2] = x[2], x[-1] = x[1]
    x[0] = vt[2];
    x[1] = vt[1];
  }
  if (c + V == w) {  // x[w] = x[w-1], x[w+1] = x[w-2]
    x[V + 2] = vt[V - 1];
    x[V + 3] = vt[V - 2];
  }
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    uint32_t o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * k + e;
      const uint32_t acc = kF0 * (x[j] + x[j + 4]) + kF1 * (x[j + 1] + x[j + 3]) + kF2 * x[j + 2];
      o[e] = (acc + 32768u) >> 16;
    }
    out[k] = o[0] | (o[1] << 16);
  }
}

// The sum of |a - b| over the columns c .. c+V-1 that lie inside the
// window [clo, chi) (chi <= w: inside the row), a and b packed as the
// horizontal pass packs them.
template <int V>
__device__ __forceinline__ uint32_t sad_packed(const uint32_t (&a)[V / 2], const uint32_t (&b)[V / 2],
                                               int c, int clo, int chi) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const uint32_t lo = (uint32_t)abs((int32_t)(a[k] & 0xffffu) - (int32_t)(b[k] & 0xffffu));
    const uint32_t hi = (uint32_t)abs((int32_t)(a[k] >> 16) - (int32_t)(b[k] >> 16));
    if (c >= clo && c + V <= chi) {
      s += lo + hi;
    } else {
      const int j = c + 2 * k;
      s += (j >= clo && j < chi ? lo : 0u) + (j + 1 >= clo && j + 1 < chi ? hi : 0u);
    }
  }
  return s;
}

// V uint16 values of a row at columns c .. c+V-1 (c >= 0): 16-byte (V = 4:
// 8-byte) accesses where the chunk is whole and aligned, else one each.
template <int V>
__device__ __forceinline__ bool u16_vector(const uint16_t* p, int c, int w) {
  return c + V <= w && reinterpret_cast<uintptr_t>(p) % (V >= 8 ? 16 : 8) == 0;
}

// Loads v (packed pairs) from a uint16 row at columns c .. c+V-1 (zeros past
// the row's end).
template <int V>
__device__ __forceinline__ void load_u16(const uint16_t* __restrict__ row, int c, int w,
                                         uint32_t (&v)[V / 2]) {
  const uint16_t* p = row + c;
  if (u16_vector<V>(p, c, w)) {
    if constexpr (V == 4) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = q.x;
      v[1] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < V / 8; ++k) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const uint32_t lo = c + 2 * k < w ? (uint32_t)__ldg(p + 2 * k) : 0u;
    const uint32_t hi = c + 2 * k + 1 < w ? (uint32_t)__ldg(p + 2 * k + 1) : 0u;
    v[k] = lo | (hi << 16);
  }
}

template <int V>
__device__ __forceinline__ void store_u16(uint16_t* __restrict__ row, int c, int w,
                                          const uint32_t (&v)[V / 2]) {
  uint16_t* p = row + c;
  if (u16_vector<V>(p, c, w)) {
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
    } else {
#pragma unroll
      for (int k = 0; k < V / 8; ++k) {
        reinterpret_cast<uint4*>(p)[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    if (c + 2 * k < w) p[2 * k] = (uint16_t)(v[k] & 0xffffu);
    if (c + 2 * k + 1 < w) p[2 * k + 1] = (uint16_t)(v[k] >> 16);
  }
}

// grid: (nseg, ceil(h / (kWarps * kRows))), nseg = ceil(w / (kSegChunks *
// V)) row segments; block: kWarps * 32 threads.  sad_rows == nullptr: blur
// only (prev0, prev, clo and chi unused); else sad_rows is zeroed and sums
// the columns [clo, chi), against frame b-1's blur (prev0 for frame 0) or,
// where prev is not null, against frame b's own plane at prev + b *
// prev_bstride.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
motion_kernel(const T* __restrict__ y, const uint16_t* __restrict__ prev0,
              const uint16_t* __restrict__ prev, int prev_bstride, int images, int h, int w,
              int depth, int clo, int chi, uint16_t* __restrict__ blurred,
              int64_t* __restrict__ sad_rows) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.y * kWarps + warp) * kRows;
  if (r0 >= h) return;  // the whole warp
  const int c = (blockIdx.x * kSegChunks + lane - 1) * V;  // this lane's first column
  const bool writes = lane >= 1 && lane <= kSegChunks;
  const bool with_sad = sad_rows != nullptr;
  const uint32_t half = 1u << (depth - 1);
  const size_t npx = (size_t)h * w;
  size_t off[kWin];  // the window's mirrored rows, the same in every frame
#pragma unroll
  for (int k = 0; k < kWin; ++k) off[k] = (size_t)mirror(r0 - 2 + k, h) * w;

  // This lane's blurred samples of the previous frame, packed: loaded for
  // frame 0 (from prev0) or, with per-frame planes, for every frame;
  // otherwise carried from this warp's blur of frame b-1.
  uint32_t last[kRows][V / 2];
#pragma unroll 1
  for (int b = 0; b < images; ++b) {
    if (with_sad && writes && (b == 0 || prev != nullptr)) {
      const uint16_t* plane = prev != nullptr ? prev + (size_t)b * prev_bstride : prev0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) last[i][k] = 0u;
        if (r0 + i < h) load_u16<V>(plane + (size_t)(r0 + i) * w, c, w, last[i]);
      }
    }
    uint4 win[kWin];
    const T* f = y + (size_t)b * npx;
#pragma unroll
    for (int k = 0; k < kWin; ++k) win[k] = load_chunk<T>(f + off[k], c, w);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      if (r >= h) break;  // uniform over the warp
      uint32_t vt[V], out[V / 2];
      vertical<T>(win, i, half, depth, vt);
      horizontal<V>(vt, c, w, out);
      if (writes) store_u16<V>(blurred + b * npx + (size_t)r * w, c, w, out);
      if (!with_sad) continue;
      uint32_t s = 0;
      if (writes) {
        s = sad_packed<V>(out, last[i], c, clo, chi);
#pragma unroll
        for (int k = 0; k < V / 2; ++k) last[i][k] = out[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      // The low word of the little-endian int64: a uint32 sum mod 2^32.
      if (lane == 0) atomicAdd(reinterpret_cast<unsigned int*>(sad_rows + (size_t)b * h + r), s);
    }
  }
}

template <typename T>
void launch_type(const void* y, const uint16_t* prev0, const uint16_t* prev, int prev_bstride,
                 int images, int h, int w, int depth, int clo, int chi, uint16_t* blurred,
                 int64_t* sad_rows, dim3 grid, cudaStream_t s) {
  motion_kernel<T><<<grid, kWarps * 32, 0, s>>>(static_cast<const T*>(y), prev0, prev, prev_bstride,
                                                images, h, w, depth, clo, chi, blurred, sad_rows);
}

int launch(const void* y, int type, const uint16_t* prev0, const uint16_t* prev, int prev_bstride,
           int images, int h, int w, int depth, int clo, int chi, uint16_t* blurred, int64_t* sad_rows,
           void* stream) {
  if (h < 3 || w < 3 || depth < 1 || depth > 16 || images < 1 || type < 0 || type > 2 || clo < 0 ||
      clo > chi || chi > w) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sad_rows != nullptr) {
    const cudaError_t err = cudaMemsetAsync(sad_rows, 0, (size_t)images * h * sizeof(int64_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  // Row segments x bands of kWarps * kRows rows, whatever the frame count.
  const int per_seg = kSegChunks * 16 / (type == 0 ? 1 : type == 1 ? 2 : 4);
  const dim3 grid((w + per_seg - 1) / per_seg, (h + kWarps * kRows - 1) / (kWarps * kRows));
  switch (type) {
    case 0:
      launch_type<uint8_t>(y, prev0, prev, prev_bstride, images, h, w, depth, clo, chi, blurred, sad_rows,
                           grid, s);
      break;
    case 1:
      launch_type<uint16_t>(y, prev0, prev, prev_bstride, images, h, w, depth, clo, chi, blurred, sad_rows,
                            grid, s);
      break;
    default:
      launch_type<int32_t>(y, prev0, prev, prev_bstride, images, h, w, depth, clo, chi, blurred, sad_rows,
                           grid, s);
      break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, motion_kernel<T>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, motion_kernel<T>, kWarps * 32, 0);
  }
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// y (images, h, w) luma of type 0 u8, 1 u16, 2 int32, at `depth` bits;
// the previous blurred frames, exactly one of: prev0 (h, w) uint16, the
// blurred frame before frame 0 (frame b's is frame b-1's blur), or prev,
// frame b's own (h, w) uint16 plane at prev + b * prev_bstride (in samples,
// prev_bstride >= 0).  Writes blurred (images, h, w) uint16 and sad_rows
// (images, h) int64 (uint32 row sums of |blurred - previous blurred| over the
// columns [clo, chi), 0 <= clo <= chi <= w; 0 and w: the whole row).
int tm_motion_stats(const void* y, int type, const uint16_t* prev0, const uint16_t* prev,
                    int prev_bstride, int images, int h, int w, int depth, int clo, int chi,
                    uint16_t* blurred, int64_t* sad_rows, void* stream) {
  if ((prev0 == nullptr) == (prev == nullptr) || prev_bstride < 0 || sad_rows == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(y, type, prev0, prev, prev_bstride, images, h, w, depth, clo, chi, blurred, sad_rows,
                stream);
}

// The blur alone: y (images, h, w) -> blurred (images, h, w) uint16.
int tm_integer_blur(const void* y, int type, int images, int h, int w, int depth,
                    uint16_t* blurred, void* stream) {
  return launch(y, type, nullptr, nullptr, 0, images, h, w, depth, 0, w, blurred, nullptr, stream);
}

// What motion_kernel<T> takes on this card (type 0 u8, 1 u16, 2 int32):
// out[0] registers per thread, out[1] static shared memory per block in
// bytes, out[2] resident blocks per SM, out[3] local memory per thread in
// bytes (spills).
int tm_motion_attrs(int type, int* out) {
  const cudaError_t err = type == 0 ? attrs<uint8_t>(out) : type == 1 ? attrs<uint16_t>(out)
                          : type == 2 ? attrs<int32_t>(out) : cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
