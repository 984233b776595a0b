// The small SSIMULACRA2 pyramid levels in one persistent launch on Hopper
// (sm_90a): every level from a linear-RGB plane down, XYB, the 11-tap blur of
// four quantities, the maps and their sums, each level's 2x2 mean feeding the
// next.
//
// Replaces turbo_metrics_tpu/ops/pallas/scale_stats.py fused_tail_pallas
// (l.2494): one grid step per batch element with every level resident in
// VMEM, written so that the ~0.8 ms fixed cost per level of the per-level
// kernels went away.  On this card the small levels' cost is likewise not
// their work (at 3840x2160, B=4, levels 3-5 hold 12.4 + 3.1 + 0.8 MB of
// linear RGB and ~0.5 GFLOP, a few microseconds of the card) but the launches
// and the host between them: the per-level route (kernel 2) issues four
// launches and an allocation per level.  The design:
//   * one cooperative launch (cudaLaunchCooperativeKernel) of as many blocks
//     as are co-resident (occupancy x SMs); grid-stride loops over the work
//     of each phase, phases separated by cooperative_groups grid syncs.  Per
//     level: (a) the quad pass, XYB and the next level's mean into one of
//     two ping-pong planes; (b) the row pass of the four quantities; (c) the
//     column pass, the maps and per-tile f32 partials into that level's
//     slot; then one last phase reduces every level's partials in f64.  Three
//     syncs per level.  Between phases the planes stay in the 50 MB L2.
//   * partials belong to fixed 32x8 tiles of the level (the sub-tiles of
//     ssimulacra2_scale.cu's fused level kernel), never to block indices, and
//     every sum is taken in a fixed order: the sums depend neither on the
//     occupancy nor on the run, and equal the per-level route's (the same
//     per-pixel code, ssimulacra2_level.cuh, and the same trees, level.cuh).
//   * one scratch allocation sized from the first level (the caller's).
// A refused cooperative launch (a grid that cannot be co-resident) is
// returned as the CUDA error; nothing falls back.  Thread-block clusters with
// distributed shared memory for the smallest levels, and the row and column
// passes fused over shared-memory tiles as the per-level route does, are
// later work.
//
// Layouts (all contiguous, f32):
//   p12   (2, B, 3, h0, w0)         linear RGB of the first level
//   xyb   (2, B, 3, h0, w0)         XYB of the current level (scratch)
//   tmp   (4, B*3, h0, w0)          row-blurred x1, x2, (x1-x2)^2, x1*x2
//   lvl_a, lvl_b (2, B, 3, ceil(h0/2), ceil(w0/2))   the next levels
//   parts per level l: (B*3, nblk_l, 6), the levels one after another
//   sums  (B, levels, 3, 6)         (d, d^4, art, art^4, det, det^4)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "level.cuh"
#include "ssimulacra2_level.cuh"

namespace cg = cooperative_groups;

namespace {

struct TailArgs {
  const float* p12;
  int batch, h0, w0, levels;
  const float* taps;
  const float* opsin;
  float* xyb;
  float* tmp;
  float* lvl[2];
  float* parts;
  float* sums;
};

__device__ __forceinline__ int level_tiles_x(int w) { return (w + kBx - 1) / kBx; }
__device__ __forceinline__ int level_tiles_y(int h) { return (h + kBy - 1) / kBy; }

// Horizontal pass at column c of one row: a and b point at the row of the
// reference's and the distorted image's XYB plane; taps outside [0, w) are
// skipped.  s: blurred x1, x2, (x1-x2)^2, x1*x2.
__device__ __forceinline__ void blur_row_px(const float* __restrict__ a,
                                            const float* __restrict__ b, int c, int w,
                                            const float* __restrict__ taps, float (&s)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int cc = c + k - kRadius;
    if (cc >= 0 && cc < w) row_tap(s, __ldg(taps + k), a[cc], b[cc]);
  }
}

// Vertical pass at row r (taps outside [0, h) skipped) of the four
// row-blurred quantities, base pointing at (row 0, this column) of the first
// and qstride apart; then the maps from the XYB samples i1 (reference) and i2
// (distorted) at the pixel.  v: d, d^4, art, art^4, det, det^4.
__device__ __forceinline__ void blur_col_maps_px(const float* __restrict__ base, size_t qstride,
                                                 int r, int h, int w,
                                                 const float* __restrict__ taps, float i1,
                                                 float i2, float (&v)[6]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int rr = r + k - kRadius;
    if (rr >= 0 && rr < h) {
      const float* row = base + (size_t)rr * w;
      const float x[4] = {row[0], row[qstride], row[2 * qstride], row[3 * qstride]};
      col_tap(s, __ldg(taps + k), x);
    }
  }
  ssim_maps(s, i1, i2, v);
}

// block: kThreads threads (1-D); grid: co-resident blocks, cooperative.
__global__ void __launch_bounds__(kThreads) fused_tail_kernel(TailArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[6][kThreads];
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  const int planes = 3 * a.batch;
  float o[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) o[k] = __ldg(a.opsin + k);

  const float* cur = a.p12;
  float* parts = a.parts;
  int h = a.h0, w = a.w0;
  for (int l = 0; l < a.levels; ++l) {
    const int hq = (h + 1) / 2, wq = (w + 1) / 2;
    const size_t npx = (size_t)h * w, nq = (size_t)hq * wq;
    const size_t qstride = (size_t)planes * npx;  // one quantity's planes
    float* next = l + 1 < a.levels ? a.lvl[l % 2] : nullptr;

    // (a) quads of both images: XYB and the next level.
    const size_t nquads = 2 * (size_t)a.batch * nq;
    for (size_t i = tid; i < nquads; i += nthreads) {
      const size_t img = i / nq, q = i - img * nq;
      const int qi = (int)(q / wq), qj = (int)(q - (size_t)qi * wq);
      rgb_quad(cur + img * 3 * npx, h, w, qi, qj, o, a.xyb + img * 3 * npx,
               next != nullptr ? next + img * 3 * nq + q : nullptr, nq);
    }
    grid.sync();

    // (b) the row pass of every (batch, channel) plane.
    for (size_t i = tid; i < qstride; i += nthreads) {
      const size_t px = i % npx;
      const int c = (int)(px % w);
      float s[4];
      blur_row_px(a.xyb + (i - c), a.xyb + qstride + (i - c), c, w, a.taps, s);
#pragma unroll
      for (int q = 0; q < 4; ++q) a.tmp[q * qstride + i] = s[q];
    }
    grid.sync();

    // (c) the column pass and the maps, one 32x8 tile per block at a time,
    // each tile's partials into its slot.
    const int ntx = level_tiles_x(w), nblk = ntx * level_tiles_y(h);
    const size_t ntiles = (size_t)planes * nblk;
    const int tx = threadIdx.x % kBx, ty = threadIdx.x / kBx;
    for (size_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const size_t plane = t / nblk;
      const int blk = (int)(t - plane * nblk);
      const int c = (blk % ntx) * kBx + tx, r = (blk / ntx) * kBy + ty;
      float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < h && c < w) {
        const size_t at = plane * npx + (size_t)r * w + c;
        blur_col_maps_px(a.tmp + plane * npx + c, qstride, r, h, w, a.taps, a.xyb[at],
                         a.xyb[qstride + at], v);
      }
      tile_partials<6>(v, red, parts + t * 6);
      __syncthreads();
    }
    parts += ntiles * 6;
    grid.sync();  // the next level's passes overwrite xyb and tmp
    cur = next;
    h = hq;
    w = wq;
  }

  // Every (level, plane)'s partials in f64, in a fixed order (level.cuh).
  const float* src = a.parts;
  h = a.h0;
  w = a.w0;
  for (int l = 0; l < a.levels; ++l) {
    const int nblk = level_tiles_x(w) * level_tiles_y(h);
    for (int p = 0; p < planes; ++p) {
      if ((l * planes + p) % (int)gridDim.x == (int)blockIdx.x) {
        const int b = p / 3, ch = p % 3;
        reduce_plane<6>(src + (size_t)p * nblk * 6, nblk,
                        a.sums + ((size_t)b * a.levels + l) * 18 + ch * 6);
        __syncthreads();
      }
    }
    src += (size_t)planes * nblk * 6;
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
}

}  // namespace

extern "C" {

// All `levels` levels from the first, p12 (2,B,3,h,w), in one cooperative
// launch: the replacement of fused_tail_pallas (turbo_metrics_tpu/ops/pallas/
// scale_stats.py:2494).  Scratch (the caller's): xyb 2*B*3*h*w floats, tmp
// 4*B*3*h*w, lvl_a and lvl_b 2*B*3*ceil(h/2)*ceil(w/2) each, parts the sum
// over the levels of B*3*tm_level_blocks(h_l,w_l)*6.  sums (B,levels,3,6).
int tm_fused_tail(const float* p12, int batch, int h, int w, int levels, const float* taps,
                  const float* opsin, float* xyb, float* tmp, float* lvl_a, float* lvl_b,
                  float* parts, float* sums, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  TailArgs a = {p12, batch, h, w, levels, taps, opsin, xyb, tmp, {lvl_a, lvl_b}, parts, sums};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fused_tail_kernel, dim3(per_sm * sms),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
