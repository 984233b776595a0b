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
// What bounds it on this card: device-memory traffic.  Per pixel it reads
// one reference, one distorted and one previous-reference sample (u8 or u16,
// or int32 luma codes of RGB sources) and does ~20 integer operations; it
// writes 24 bytes per 256 pixels (three sums as int64).  What the design
// does about it: a block covers 16 rows x 64 columns (four XPSNR blocks), so
// a warp reads 32 consecutive samples of a row; each thread issues its
// distorted and previous-frame loads before the reference tile's, so that
// all of its loads are in flight at once; the reference tile and its
// 1-pixel halo are staged once in shared memory for the 9 highpass taps.
// The previous frame of frame b is reference frame b-1 of the same batch
// (frame 0 reads the plane carried over from the previous batch), so no
// third batch of planes is uploaded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;           // XPSNR block side
constexpr int kTileW = 64;           // columns per thread block (four XPSNR blocks)
constexpr int kRowsPerThread = 4;    // a thread walks 4 rows of its column
constexpr int kTy = kBlock / kRowsPerThread;
constexpr int kThreads = kTileW * kTy;
constexpr int kSh = kBlock + 2, kSw = kTileW + 2;

// grid: (ceil(w/64), ceil(h/16), B), block: (64, 4)
template <typename TR, typename TD>
__global__ void __launch_bounds__(kThreads)
xpsnr_kernel(const TR* __restrict__ ref, const TD* __restrict__ dis, const TR* __restrict__ prev0,
             int h, int w, int dis_shift, int64_t* __restrict__ out) {
  __shared__ int32_t tile[kSh][kSw];
  __shared__ uint32_t red[kTy][kTileW / kBlock][3];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int col0 = blockIdx.x * kTileW;
  const int row0 = blockIdx.y * kBlock;
  const int b = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const TR* r_img = ref + b * npx;
  const TD* d_img = dis + b * npx;
  const TR* p_img = b == 0 ? prev0 : ref + (b - 1) * npx;
  const int c = col0 + tx;

  // This thread's distorted (depth-aligned) and previous-frame samples.
  int32_t dv[kRowsPerThread], pv[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + ty + k * kTy;
    dv[k] = pv[k] = 0;
    if (r < h && c < w) {
      const size_t at = (size_t)r * w + c;
      const int32_t d = (int32_t)d_img[at];
      dv[k] = dis_shift >= 0 ? d << dis_shift : d >> -dis_shift;
      pv[k] = (int32_t)p_img[at];
    }
  }

  // The reference tile with a 1-pixel halo, edge-replicated at the borders.
  for (int i = tid; i < kSh * kSw; i += kThreads) {
    const int ti = i / kSw, tj = i % kSw;
    const int tr = min(max(row0 - 1 + ti, 0), h - 1);
    const int tc = min(max(col0 - 1 + tj, 0), w - 1);
    tile[ti][tj] = (int32_t)r_img[(size_t)tr * w + tc];
  }
  __syncthreads();

  uint32_t sse = 0, sact = 0, tact = 0;
  if (c < w) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int ti = ty + k * kTy;
      const int r = row0 + ti;
      if (r < h) {
        const int i = ti + 1, j = tx + 1;
        const int32_t x = tile[i][j];
        const int32_t hp = 12 * x
                           - 2 * (tile[i - 1][j] + tile[i + 1][j] + tile[i][j - 1] + tile[i][j + 1])
                           - (tile[i - 1][j - 1] + tile[i - 1][j + 1] + tile[i + 1][j - 1]
                              + tile[i + 1][j + 1]);
        const uint32_t err = (uint32_t)(x - dv[k]);
        sse += err * err;
        sact += (uint32_t)abs(hp);
        tact += (uint32_t)abs(x - pv[k]);
      }
    }
  }

  // Each half-warp is one column band of one XPSNR block: sum its 16 lanes,
  // then the 4 row groups.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
    sact += __shfl_xor_sync(0xffffffffu, sact, off);
    tact += __shfl_xor_sync(0xffffffffu, tact, off);
  }
  if ((tx & (kBlock - 1)) == 0) {
    red[ty][tx / kBlock][0] = sse;
    red[ty][tx / kBlock][1] = sact;
    red[ty][tx / kBlock][2] = tact;
  }
  __syncthreads();
  if (tid < (kTileW / kBlock) * 3) {
    const int blk = tid / 3, q = tid % 3;
    const int bx = blockIdx.x * (kTileW / kBlock) + blk;
    const int hb = gridDim.y, wb = (w + kBlock - 1) / kBlock;
    if (bx < wb) {
      uint32_t s = 0;
#pragma unroll
      for (int t = 0; t < kTy; ++t) s += red[t][blk][q];
      out[(((size_t)q * gridDim.z + b) * hb + blockIdx.y) * wb + bx] = (int64_t)s;
    }
  }
}

template <typename TR, typename TD>
void launch(const void* ref, const void* dis, const void* prev0, int images, int h, int w,
            int dis_shift, int64_t* out, cudaStream_t s) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kBlock - 1) / kBlock, images);
  const dim3 block(kTileW, kTy);
  xpsnr_kernel<TR, TD><<<grid, block, 0, s>>>(static_cast<const TR*>(ref),
                                              static_cast<const TD*>(dis),
                                              static_cast<const TR*>(prev0), h, w, dis_shift, out);
}

template <typename TR>
int launch_dis(const void* ref, const void* dis, int dis_type, const void* prev0, int images,
               int h, int w, int dis_shift, int64_t* out, cudaStream_t s) {
  switch (dis_type) {
    case 0: launch<TR, uint8_t>(ref, dis, prev0, images, h, w, dis_shift, out, s); break;
    case 1: launch<TR, uint16_t>(ref, dis, prev0, images, h, w, dis_shift, out, s); break;
    case 2: launch<TR, int32_t>(ref, dis, prev0, images, h, w, dis_shift, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// ref (images, h, w) and prev0 (h, w) of one type, dis (images, h, w) of
// another; types: 0 u8, 1 u16, 2 int32.  The distorted samples are shifted
// left by dis_shift bits (right when negative) before the comparison.  out:
// (3, images, ceil(h/16), ceil(w/16)) int64, the SSE, spatial and temporal
// activity grids (uint32 values, as torch holds them).
int tm_xpsnr_block_stats(const void* ref, int ref_type, const void* dis, int dis_type,
                         const void* prev0, int images, int h, int w, int dis_shift,
                         int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status;
  switch (ref_type) {
    case 0: status = launch_dis<uint8_t>(ref, dis, dis_type, prev0, images, h, w, dis_shift, out, s); break;
    case 1: status = launch_dis<uint16_t>(ref, dis, dis_type, prev0, images, h, w, dis_shift, out, s); break;
    case 2: status = launch_dis<int32_t>(ref, dis, dis_type, prev0, images, h, w, dis_shift, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (status != 0) return status;
  return (int)cudaGetLastError();
}

}  // extern "C"
