// The blur-only timing probe on Hopper (sm_90a): `passes` repetitions of the
// 11-tap row blur then column blur of each f32 plane, zero-extended at the
// image's border, each repetition's result summed over a region of the plane.
//
// Replaces the probe of tools/kernel_dissect.py (`blur_only`, pallas_call at
// l.106, kernel body `blur_only_kernel` at l.70), which measures the blur
// work of the fused-scale kernel alone.  The TPU probe zero-pads each plane in
// a separate pass and walks (144, 640) VMEM tiles of 128x512 outputs; the
// region it sums is the blur of image rows [0, nth*128) x columns
// [0, ntw*512): the bottom and right spill past the image edge counted, the
// top and left spill not.  The (144, 640) f32 tile is 369 KB, more than an
// SM's shared memory, so here the tile is the card's own: one block per 32x128
// output tile of that region.  The region is whole 128x512 TPU tiles, so it is
// whole blocks too (tm_blur_probe refuses a region that is not).
//
// What bounds it on this card: its f32 operations (per summed pixel 5
// repetitions x 2 directions x 11 multiply-adds, 220 operations), not its
// bytes (each input pixel read once).  What the design does about it:
//   * the block reads its input tile with the 5-pixel halo once, straight
//     from the unpadded plane (bounds checks give the zeros: no padded copy);
//   * every repetition really runs: the row pass writes the row-blurred tile
//     to shared memory and the column pass reads it back after a barrier, so
//     the compiler cannot compute one repetition and reuse it;
//   * the column pass keeps a 26-row window of one column in registers and
//     gives 16 outputs from it (1.6 shared loads per output);
//   * the row pass reads 11 shared values per output: its shared-memory
//     loads, not its multiply-adds, are the limit of this simple design.
// Sums are deterministic: each thread adds its outputs in a fixed order, the
// block reduces them in level.cuh's fixed f32 tree, and reduce_plane adds a
// plane's tile partials in f64 in a fixed order (no atomics).
//
// Layouts (all contiguous):
//   x      (planes, h, w)          f32
//   taps   (11,)                   f32, on the device
//   parts  (planes, nblk)          f32 per-tile partial sums (scratch)
//   out    (planes, 8, 8)          f32, the total in [p, 0, 0], zeros elsewhere

#include <cuda_runtime.h>

#include "level.cuh"

namespace {

constexpr int kProbeRadius = 5;
constexpr int kProbeTaps = 2 * kProbeRadius + 1;
constexpr int kProbeTh = 32;   // output rows of a block's tile
constexpr int kProbeTw = 128;  // output columns of a block's tile
constexpr int kInH = kProbeTh + 2 * kProbeRadius;
constexpr int kInW = kProbeTw + 2 * kProbeRadius;
constexpr int kColRows = 16;  // outputs of one thread in the column pass
constexpr int kColWin = kColRows + 2 * kProbeRadius;
static_assert(kThreads == kProbeTw * (kProbeTh / kColRows), "one column segment per thread");

// grid: (region_w / kProbeTw, region_h / kProbeTh, planes), block: kThreads (1-D)
__global__ void __launch_bounds__(kThreads)
blur_probe_kernel(const float* __restrict__ x, int h, int w, int passes,
                  const float* __restrict__ taps, float* __restrict__ parts) {
  __shared__ float in[kInH][kInW];
  __shared__ float rows[kInH][kProbeTw];
  __shared__ float red[1][kThreads];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kProbeTh, c0 = blockIdx.x * kProbeTw;
  const size_t plane = blockIdx.z;
  const float* src = x + plane * h * w;
  float t[kProbeTaps];
#pragma unroll
  for (int k = 0; k < kProbeTaps; ++k) t[k] = __ldg(taps + k);

  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int ir = i / kInW, ic = i % kInW;
    const int r = r0 - kProbeRadius + ir, c = c0 - kProbeRadius + ic;
    in[ir][ic] = (r >= 0 && r < h && c >= 0 && c < w) ? src[(size_t)r * w + c] : 0.0f;
  }
  __syncthreads();

  // This thread's column segment: column col, rows row0 .. row0 + kColRows.
  const int col = tid % kProbeTw, row0 = (tid / kProbeTw) * kColRows;
  float acc = 0.0f;
  for (int p = 0; p < passes; ++p) {
    for (int i = tid; i < kInH * kProbeTw; i += kThreads) {
      const int r = i / kProbeTw, c = i % kProbeTw;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kProbeTaps; ++k) s += t[k] * in[r][c + k];
      rows[r][c] = s;
    }
    __syncthreads();
    float v[kColWin];
#pragma unroll
    for (int j = 0; j < kColWin; ++j) v[j] = rows[row0 + j][col];
#pragma unroll
    for (int i = 0; i < kColRows; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kProbeTaps; ++k) s += t[k] * v[i + k];
      acc += s;
    }
    __syncthreads();  // the next repetition overwrites rows
  }
  const float v1[1] = {acc};
  block_partials<1>(v1, red, parts, plane);
}

// One plane per block: the f64 sum of its tile partials into out[p, 0, 0],
// zeros into the plane's other 63 entries.
// grid: (planes), block: kReduceThreads
__global__ void __launch_bounds__(kReduceThreads)
probe_reduce_kernel(const float* __restrict__ parts, int nblk, float* __restrict__ out) {
  float* o = out + (size_t)blockIdx.x * 64;
  if (threadIdx.x > 0 && threadIdx.x < 64) o[threadIdx.x] = 0.0f;
  reduce_plane<1>(parts + (size_t)blockIdx.x * nblk, nblk, o);
}

dim3 probe_grid(int region_h, int region_w, int planes) {
  return dim3(region_w / kProbeTw, region_h / kProbeTh, planes);
}

}  // namespace

extern "C" {

// Number of tile partials tm_blur_probe writes per plane for a region of
// region_h x region_w (whole 32x128 tiles): the caller sizes `parts` as
// planes * nblk floats.
int tm_blur_probe_blocks(int region_h, int region_w) {
  const dim3 g = probe_grid(region_h, region_w, 1);
  return (int)(g.x * g.y);
}

// The replacement of blur_only (tools/kernel_dissect.py:106): x (planes, h,
// w) -> out (planes, 8, 8), out[p, 0, 0] = the sum over passes of the blurred
// plane over rows [0, region_h) x columns [0, region_w), the image
// zero-extended.  planes at most 65535; the region whole 32x128 tiles, else
// cudaErrorInvalidValue and no launch.
int tm_blur_probe(const float* x, int planes, int h, int w, int region_h, int region_w,
                  int passes, const float* taps, float* parts, float* out, void* stream) {
  if (region_h <= 0 || region_w <= 0 || region_h % kProbeTh || region_w % kProbeTw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = probe_grid(region_h, region_w, planes);
  blur_probe_kernel<<<grid, kThreads, 0, s>>>(x, h, w, passes, taps, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_reduce_kernel<<<planes, kReduceThreads, 0, s>>>(parts, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
