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
//
// Borders are the reference's asymmetric mirror: x[-1] = x[1], x[-2] = x[2]
// at the low edge, x[n] = x[n-1], x[n+1] = x[n-2] at the high edge (frames
// of at least 3x3).
//
// Where the previous blurred frame comes from: frame b's previous frame is
// frame b-1 of the same batch, and frame 0's is the plane the caller carries
// over from the previous batch.  A block never reads another block's output
// (no order between blocks): it recomputes frame b-1's blur over its own
// tile from frame b-1's luma (a 2-pixel halo; integer work is cheap next to
// the bytes), so one launch writes the blurred batch and the row SADs.
//
// What bounds it on this card: device-memory traffic.  Per pixel it reads one
// luma sample (u8, u16, or int32 luma codes of RGB sources) and writes one
// uint16 (the previous frame's luma is read again, mostly from L2), against
// ~25 integer operations per blur.  What the design does about it: a block
// owns 8 full rows of one frame and walks them in 128-column tiles, staging
// the tile and its 2-pixel halo once in shared memory (warps read 32
// consecutive samples of a row); the vertical pass is computed once per
// column of the tile and kept in shared memory for the horizontal pass; each
// thread keeps its rows' SADs in registers across the tiles, so the row sums
// leave the block complete (no second pass, no atomics; integer sums are
// exact in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTw = 128;                      // columns per tile
constexpr int kTh = 8;                        // rows per block
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTh * kTw / kThreads;  // 4
constexpr int kRowStep = kThreads / kTw;              // 2
constexpr int kWarpsPerRow = kTw / 32;                // 4
constexpr int kRadius = 2;
__constant__ uint32_t kFilter[5] = {3571u, 16004u, 26386u, 16004u, 3571u};

// The asymmetric mirror for i in [-2, n+1], n >= 3.
__device__ __forceinline__ int mirror(int i, int n) {
  i = abs(i);
  return i < n ? i : 2 * n - 1 - i;
}

// The blurred samples of this thread's pixels (rows row0 + tr + k*kRowStep,
// column col0 + tc) of one frame.  Every thread of the block calls it (it
// synchronises); pixels outside the frame get unused values.
template <typename T>
__device__ __forceinline__ void blur_tile(const T* __restrict__ img, int h, int w, int depth,
                                          int row0, int col0, uint32_t (*in)[kTw + 2 * kRadius],
                                          uint32_t (*vt)[kTw + 2 * kRadius],
                                          uint32_t (&out)[kRowsPerThread]) {
  constexpr int kInH = kTh + 2 * kRadius, kInW = kTw + 2 * kRadius;
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int ti = i / kInW, tj = i % kInW;
    // Rows and columns past n+1 feed only pixels outside the frame.
    const int r = mirror(min(row0 - kRadius + ti, h + 1), h);
    const int c = mirror(min(col0 - kRadius + tj, w + 1), w);
    in[ti][tj] = (uint32_t)img[(size_t)r * w + c];
  }
  __syncthreads();
  const uint32_t half = 1u << (depth - 1);
  for (int i = threadIdx.x; i < kTh * kInW; i += kThreads) {
    const int ti = i / kInW, tj = i % kInW;
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) acc += kFilter[k] * in[ti + k][tj];
    vt[ti][tj] = (acc + half) >> depth;
  }
  __syncthreads();
  const int tc = threadIdx.x % kTw, tr = threadIdx.x / kTw;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ti = tr + k * kRowStep;
    uint32_t acc = 0;
#pragma unroll
    for (int f = 0; f < 5; ++f) acc += kFilter[f] * vt[ti][tc + f];
    out[k] = (acc + 32768u) >> 16;
  }
}

// grid: (ceil(h/kTh), images), block: kThreads.  prev0 == nullptr: blur only.
template <typename T>
__global__ void __launch_bounds__(kThreads)
motion_kernel(const T* __restrict__ y, const uint16_t* __restrict__ prev0, int h, int w, int depth,
              uint16_t* __restrict__ blurred, int64_t* __restrict__ sad_rows) {
  __shared__ uint32_t in[kTh + 2 * kRadius][kTw + 2 * kRadius];
  __shared__ uint32_t vt[kTh][kTw + 2 * kRadius];
  __shared__ uint32_t part[kTh][kWarpsPerRow];
  const int row0 = blockIdx.x * kTh;
  const int b = blockIdx.y;
  const size_t npx = (size_t)h * w;
  const T* cur = y + b * npx;
  const int tc = threadIdx.x % kTw, tr = threadIdx.x / kTw;
  const bool with_sad = prev0 != nullptr;
  uint32_t sad[kRowsPerThread] = {0u, 0u, 0u, 0u};

  for (int col0 = 0; col0 < w; col0 += kTw) {
    uint32_t bc[kRowsPerThread], bp[kRowsPerThread];
    blur_tile<T>(cur, h, w, depth, row0, col0, in, vt, bc);
    const int c = col0 + tc;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = row0 + tr + k * kRowStep;
      if (r < h && c < w) blurred[b * npx + (size_t)r * w + c] = (uint16_t)bc[k];
    }
    if (!with_sad) {
      __syncthreads();  // the next tile overwrites the shared tiles
      continue;
    }
    if (b > 0) {
      __syncthreads();
      blur_tile<T>(cur - npx, h, w, depth, row0, col0, in, vt, bp);
    } else {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = row0 + tr + k * kRowStep;
        bp[k] = (r < h && c < w) ? (uint32_t)prev0[(size_t)r * w + c] : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = row0 + tr + k * kRowStep;
      if (r < h && c < w) sad[k] += (uint32_t)abs((int32_t)bc[k] - (int32_t)bp[k]);
    }
    __syncthreads();
  }
  if (!with_sad) return;

  // A warp covers 32 columns of one row: sum its lanes, then the row's warps.
  const int lane = threadIdx.x & 31, warp_in_row = tc / 32;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    uint32_t s = sad[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[tr + k * kRowStep][warp_in_row] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTh) {
    const int r = row0 + threadIdx.x;
    if (r < h) {
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) s += part[threadIdx.x][q];
      sad_rows[(size_t)b * h + r] = (int64_t)s;
    }
  }
}

int launch(const void* y, int type, const uint16_t* prev0, int images, int h, int w, int depth,
           uint16_t* blurred, int64_t* sad_rows, void* stream) {
  if (h < 3 || w < 3 || depth < 1 || depth > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((h + kTh - 1) / kTh, images);
  switch (type) {
    case 0:
      motion_kernel<uint8_t><<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(y), prev0, h, w,
                                                       depth, blurred, sad_rows);
      break;
    case 1:
      motion_kernel<uint16_t><<<grid, kThreads, 0, s>>>(static_cast<const uint16_t*>(y), prev0, h,
                                                        w, depth, blurred, sad_rows);
      break;
    case 2:
      motion_kernel<int32_t><<<grid, kThreads, 0, s>>>(static_cast<const int32_t*>(y), prev0, h, w,
                                                       depth, blurred, sad_rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (images, h, w) luma of type 0 u8, 1 u16, 2 int32, at `depth` bits;
// prev0 (h, w) uint16: the blurred frame before frame 0.  Writes blurred
// (images, h, w) uint16 and sad_rows (images, h) int64 (uint32 row sums of
// |blurred - previous blurred|).
int tm_motion_stats(const void* y, int type, const uint16_t* prev0, int images, int h, int w,
                    int depth, uint16_t* blurred, int64_t* sad_rows, void* stream) {
  if (prev0 == nullptr || sad_rows == nullptr) return (int)cudaErrorInvalidValue;
  return launch(y, type, prev0, images, h, w, depth, blurred, sad_rows, stream);
}

// The blur alone: y (images, h, w) -> blurred (images, h, w) uint16.
int tm_integer_blur(const void* y, int type, int images, int h, int w, int depth,
                    uint16_t* blurred, void* stream) {
  return launch(y, type, nullptr, images, h, w, depth, blurred, nullptr, stream);
}

}  // extern "C"
