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
// linear RGB and ~0.5 GFLOP, a few microseconds of the card) but latency:
// the per-level route (kernel 2) issues three launches and an allocation per
// level, and a level of a few hundred tiles leaves most of the card idle
// while its last tiles finish.  The design:
//   * one cooperative launch (cudaLaunchCooperativeKernel) of as many blocks
//     of kTileThreads threads as are co-resident (occupancy x SMs); each
//     block walks work items in grid-stride order, and grid syncs separate
//     the steps;
//   * per level two passes: the quad pass (rgb_quad: XYB of the level and
//     the next level's 2x2 mean) and the tile pass (level_tile, the fused
//     level pass of ssimulacra2_scale.cu: the tile's XYB and halo in shared
//     memory, both blur passes and the maps there, the 32x8 partials in
//     registers and shuffles).  XYB alternates between two planes by level,
//     so the quad pass of level l+1 runs in the same step as the tile pass
//     of level l, and each level's f64 reduction of its partials in the step
//     after its tile pass (or the last step): levels + 1 grid syncs in all
//     (4 for three levels, where the two-pass design took 9).  The tiles of
//     a step come first in its item order, so that blocks start the longest
//     items first; the quad items (128 quads each) and the reductions (one
//     (level, plane) each) fill the remaining blocks.  The four row-blurred
//     planes never reach device memory.
//   * the sums equal the per-level route's (kernel 2) bit for bit: the same
//     per-pixel code and tile pass (ssimulacra2_level.cuh), partials per
//     fixed 32x8 tile of the level, never per block, and level.cuh's f64
//     reduction order (reduce_plane's 256 slots, taken two per thread by
//     these 128-thread blocks).  The sums depend neither on the occupancy
//     nor on the run.
//   * the planes and partials that blocks of this launch wrote before a grid
//     sync are read from L2 (__ldcg), never through the read-only data
//     cache, which is not coherent with writes of the same launch;
//   * one scratch allocation sized from the first level (the caller's).
// A refused cooperative launch (a grid that cannot be co-resident) is
// returned as the CUDA error; nothing falls back.
// On an H100 (4K B=4, levels 3-5) the steps take about 18, 33, 14, 8 and 2
// us: the first level's quad pass and tile pass, then the latency of one
// tile per block on the small levels.  Measured and not kept: registers
// capped for 4 or 5 blocks per SM (3 now), four quads per thread: no
// faster; two quads per thread, loaded before either is computed: 4%
// faster at 4K, 8% slower on the 1440p levels 2-5.  One phase per level
// (XYB computed in the tile from the level's linear RGB, the next level
// emitted from the tile's quads: no quad pass, levels grid syncs; the same
// sums): 0.147 against 0.079 device ms at 4K levels 3-5, 0.383 against
// 0.234 on the 1440p levels 2-5 at B=8.  Each tile recomputes the cube
// roots of all three channels on its 42x48 input, about six times the
// quad pass's work, and that outweighs the step it saves.
// Not tried: the f64 reductions shared across the grid.  A level's
// reductions fill the blocks left over in the step after its tiles; only
// the last level's run alone, in the last step (about 2 us), and splitting
// reduce_plane's fixed tree across blocks would take one more grid sync.
// Nor thread-block clusters with distributed shared memory holding the
// smallest levels.
//
// Layouts (all contiguous, f32):
//   p12   (2, B, 3, h0, w0)         linear RGB of the first level
//   xyb_even, xyb_odd                XYB of the even and the odd levels,
//         (2, B, 3, h_l, w_l)        (scratch; the odd one unused with 1 level)
//   lvl_a, lvl_b (2, B, 3, ceil(h0/2), ceil(w0/2))   the next levels
//   parts per level l: (B*3, nblk_l, 6), the levels one after another
//   sums  (B, levels, 3, 6)         (d, d^4, art, art^4, det, det^4)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "level.cuh"
#include "ssimulacra2_level.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 6;

struct TailArgs {
  const float* p12;
  int batch, h0, w0, levels;
  int clo0, chi0;  // the first level's window of owned columns
  const float* taps;
  const float* opsin;
  float* xyb[2];  // even, odd levels
  float* lvl[2];
  float* parts;
  float* sums;
};

// reduce_plane<K> (level.cuh) on a block of kTileThreads threads, half its
// kReduceThreads slots: thread t takes slots t and t + kTileThreads, whose
// sums meet in the tree's first step, so every add is reduce_plane's and the
// result its bits.  The partials come from L2 (other blocks wrote them in
// this launch).  red: K * kTileThreads doubles of shared memory; the caller
// syncs the block before it reuses them.
template <int K>
__device__ __forceinline__ void reduce_plane_half(const float* __restrict__ src, int nblk,
                                                  float* __restrict__ out, double* red) {
  static_assert(2 * kTileThreads == kReduceThreads, "two slots per thread");
  const int tid = threadIdx.x;
  double lo[K], hi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lo[k] = hi[k] = 0.0;
  for (int i = tid; i < nblk; i += kReduceThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) lo[k] += (double)__ldcg(src + (size_t)i * K + k);
  }
  for (int i = tid + kTileThreads; i < nblk; i += kReduceThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) hi[k] += (double)__ldcg(src + (size_t)i * K + k);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[k * kTileThreads + tid] = lo[k] + hi[k];
  __syncthreads();
  for (int stride = kTileThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k * kTileThreads + tid] += red[k * kTileThreads + tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = (float)red[k * kTileThreads];
  }
}

// Level l's size, its window of owned columns [clo, chi) (the first level's
// halved l times, rounded outwards: the columns its quads cover) and the
// offset of its partials in a.parts (the levels' partials one after
// another).
struct Level {
  int h, w, clo, chi;
  size_t poff;
};

__device__ __forceinline__ Level level_at(const TailArgs& a, int l) {
  Level v = {a.h0, a.w0, a.clo0, a.chi0, 0};
  for (int i = 0; i < l; ++i) {
    v.poff += (size_t)3 * a.batch * ((v.w + kBx - 1) / kBx) * ((v.h + kBy - 1) / kBy) * 6;
    v.h = (v.h + 1) / 2;
    v.w = (v.w + 1) / 2;
    v.clo /= 2;
    v.chi = (v.chi + 1) / 2;
  }
  return v;
}

// block: kTileThreads threads (1-D); grid: co-resident blocks, cooperative.
__global__ void __launch_bounds__(kTileThreads) fused_tail_kernel(TailArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) float smem[kTileSmemFloats];
  const int planes = 3 * a.batch;

  // Step k: the tile pass of level k-1, the quad pass of level k, the
  // reduction of level k-2.
  for (int k = 0; k <= a.levels + 1; ++k) {
    const int lt = k - 1, lq = k, lr = k - 2;
    const Level vt = level_at(a, max(lt, 0)), vq = level_at(a, lq), vr = level_at(a, max(lr, 0));
    int ntx = 0, ntiles = 0, nqchunks = 0, nred = 0;
    if (lt >= 0 && lt < a.levels) {
      ntx = (vt.w + kTileW - 1) / kTileW;
      ntiles = planes * ntx * ((vt.h + kTileH - 1) / kTileH);
    }
    if (lq < a.levels) {
      const int nquads = 2 * a.batch * ((vq.h + 1) / 2) * ((vq.w + 1) / 2);
      nqchunks = (nquads + kTileThreads - 1) / kTileThreads;
    }
    if (lr >= 0) nred = planes;
    for (int item = blockIdx.x; item < ntiles + nqchunks + nred; item += gridDim.x) {
      if (item < ntiles) {
        const int per_plane = ntiles / planes;
        const int plane = item / per_plane, t = item - plane * per_plane;
        const float* xa = lt % 2 ? a.xyb[1] : a.xyb[0];
        level_tile<Src::kWritten>(xa, xa + (size_t)planes * vt.h * vt.w, vt.h, vt.w, vt.clo,
                                  vt.chi, a.taps, a.parts + vt.poff, t % ntx, t / ntx, plane,
                                  smem);
      } else if (item < ntiles + nqchunks) {
        const int h = vq.h, w = vq.w;
        const int hq = (h + 1) / 2, wq = (w + 1) / 2;
        const size_t npx = (size_t)h * w, nq = (size_t)hq * wq;
        const size_t i = (size_t)(item - ntiles) * kTileThreads + threadIdx.x;
        if (i < 2 * (size_t)a.batch * nq) {
          float o[11];
#pragma unroll
          for (int j = 0; j < 11; ++j) o[j] = __ldg(a.opsin + j);
          const float* cur = lq == 0 ? a.p12 : lq % 2 ? a.lvl[0] : a.lvl[1];
          float* next = lq + 1 == a.levels ? nullptr : lq % 2 ? a.lvl[1] : a.lvl[0];
          float* xyb = lq % 2 ? a.xyb[1] : a.xyb[0];
          const size_t img = i / nq, q = i - img * nq;
          const int qi = (int)(q / wq), qj = (int)(q - (size_t)qi * wq);
          rgb_quad<Src::kWritten>(cur + img * 3 * npx, h, w, qi, qj, o, xyb + img * 3 * npx,
                                  next != nullptr ? next + img * 3 * nq + q : nullptr, nq);
        }
      } else {
        const int p = item - ntiles - nqchunks;
        const int nblk = ((vr.w + kBx - 1) / kBx) * ((vr.h + kBy - 1) / kBy);
        reduce_plane_half<6>(a.parts + vr.poff + (size_t)p * nblk * 6, nblk,
                             a.sums + ((size_t)(p / 3) * a.levels + lr) * 18 + (p % 3) * 6,
                             reinterpret_cast<double*>(smem));
      }
      __syncthreads();  // the next item reuses the shared memory
    }
    if (k <= a.levels) grid.sync();
  }
}

cudaError_t co_resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_kernel, kTileThreads, 0);
  }
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

extern "C" {

// All `levels` levels from the first, p12 (2,B,3,h,w), in one cooperative
// launch: the replacement of fused_tail_pallas (turbo_metrics_tpu/ops/pallas/
// scale_stats.py:2494).  Scratch (the caller's): xyb_even 2*B*3*h*w floats,
// xyb_odd, lvl_a and lvl_b 2*B*3*ceil(h/2)*ceil(w/2) each, parts the sum
// over the levels of B*3*tm_level_blocks(h_l,w_l)*6.  sums (B,levels,3,6),
// over the owned columns [clo, chi) of the first level (0 and w: the whole
// level) and, on level l, [floor(clo/2^l), ceil(chi/2^l)).
int tm_fused_tail(const float* p12, int batch, int h, int w, int clo, int chi, int levels,
                  const float* taps, const float* opsin, float* xyb_even, float* xyb_odd,
                  float* lvl_a, float* lvl_b, float* parts, float* sums, void* stream) {
  if (levels < 1 || levels > kMaxLevels || batch < 1 || h < 1 || w < 1 || clo < 0 ||
      clo >= chi || chi > w) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  cudaError_t err = co_resident_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  TailArgs a = {p12, batch, h, w, levels, clo, chi, taps, opsin, {xyb_even, xyb_odd},
                {lvl_a, lvl_b}, parts, sums};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fused_tail_kernel, dim3(blocks),
                                    dim3(kTileThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

// What fused_tail_kernel takes on this card: out[0] registers per thread,
// out[1] static shared memory per block in bytes, out[2] resident blocks per
// SM, out[3] local memory per thread in bytes (spills), out[4] the blocks of
// one launch.
int tm_fused_tail_attrs(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, fused_tail_kernel);
  int per_sm = 0, blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_kernel, kTileThreads, 0);
  }
  if (err == cudaSuccess) err = co_resident_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = f.numRegs;
  out[1] = (int)f.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)f.localSizeBytes;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
