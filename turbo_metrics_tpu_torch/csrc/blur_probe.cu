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
// SM's shared memory, so here the tile is the card's own: one block per
// kProbeTh x kProbeTw output tile of that region, which divides 128x512, so
// the region is whole blocks too (tm_blur_probe refuses a region that is
// not).
//
// What bounds it on this card: its f32 operations (per summed pixel 5
// repetitions x 2 directions x 11 multiply-adds, 220 operations), not its
// bytes (each input pixel read once).  Each multiply-add is one FFMA, and an
// SM issues at most four warp instructions a clock, as many as its FFMA
// lanes take: every other instruction and every row blurred again for the
// halo comes out of the FFMA rate.  Shared memory moves 32 floats a clock
// against 128 FFMA, so an output may read about 2.75 floats for its 11
// multiply-adds.  What the design does about it:
//   * a 64x64 output tile, one block of 128 threads: the row pass blurs 74
//     rows, 1.16x the outputs; its input (74 x 80 f32 from output column
//     -8, rows 84 floats apart), row results (74 x 64, rows 68 apart) and
//     block tree take 45,504 B of static shared memory: 5 blocks, 20 warps,
//     an SM.  More warps an SM, not fewer loads, made the other tile
//     geometries measured slower (PERF.md section 6);
//   * the block reads its input tile once, by asynchronous copies straight
//     into shared memory (cp.async: 16 bytes a copy in the interior of the
//     plane, one sample a copy at its edges; zeros outside it, so no padded
//     copy of the plane), every copy in flight before the first wait;
//   * register-blocked row pass: a thread walks 32 consecutive outputs of
//     one row in registers from the 48 samples of twelve 16-byte shared
//     loads (the 42 it uses start 3 past a 16-byte boundary), 1.5 floats
//     per output instead of 11, and stores them with eight 16-byte stores.
//     The lanes of a warp take 32 consecutive rows at one column, and the
//     row strides (20 and 4 past a multiple of 32 floats) put the eight
//     lanes of each phase of a 16-byte access in eight bank groups: no
//     conflicts.  The tile's first 64 rows are one task a thread, its last
//     10 are 80 tasks of 8 outputs;
//   * the column pass keeps a window of 18 rows of 4 columns in registers
//     (16-byte loads, a warp's lanes on two rows of 64 contiguous columns)
//     and gives 8 x 4 outputs from it, 2.25 floats per output;
//   * the multiply-adds stay on the CUDA cores in full f32: TF32 is barred
//     for every product that feeds a blur (ROADMAP.md), and a banded 11-tap
//     product on the tensor cores would waste about 128/11 of its multiplies.
// Per output and repetition that is 23.7 FFMA (11 x 74/64 + 11) and about 3
// other instructions; a repetition runs at about 0.8 of the FFMA rate.
// What bounds it now is the fill of the input tiles, which overlaps the
// repetitions little.
// Every repetition really runs: the row pass writes the row-blurred tile to
// shared memory and the column pass reads it back after a barrier, so the
// compiler cannot compute one repetition and reuse it.  Each output sums its
// taps k = 0..10 in order from 0.  Sums are deterministic: each thread adds
// its outputs in a fixed order, the block reduces them in level.cuh's
// fixed f32 tree (block_partials over 128 threads), and reduce_plane adds a
// plane's tile partials in f64 in a fixed order (no atomics).
//
// Layouts (all contiguous):
//   x      (planes, h, w)          f32
//   taps   (11,)                   f32, on the device
//   parts  (planes, nblk)          f32 per-tile partial sums (scratch)
//   out    (planes, 8, 8)          f32, the total in [p, 0, 0], zeros elsewhere

#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

namespace {

constexpr int kProbeRadius = 5;
constexpr int kProbeTaps = 2 * kProbeRadius + 1;
constexpr int kProbeTh = 64;  // output rows of a block's tile
constexpr int kProbeTw = 64;  // output columns of a block's tile
constexpr int kHaloH = kProbeTh + 2 * kProbeRadius;  // rows of the input tile and the row pass
constexpr int kInOff = 8;                            // input column 0 = output column -8
constexpr int kInCols = kProbeTw + 2 * kInOff;       // input columns held (-8 .. 71; -5 .. 68 used)
// Column pass: a thread gives kColRows x 4 outputs from one register window
// of kColRows + 10 rows: thread i owns columns 4 (i % (kProbeTw / 4)) .. + 3
// and output rows kColRows (i / (kProbeTw / 4)) .. + kColRows - 1.
constexpr int kColRows = 8;
constexpr int kColWin = kColRows + 2 * kProbeRadius;
constexpr int kPThreads = (kProbeTw / 4) * (kProbeTh / kColRows);  // threads of a block
// Row strides of the input tile and the row-blurred tile, in floats: 20 and
// 4 past a multiple of 32, so that the 16-byte accesses of eight lanes on
// eight consecutive rows at one column fall in eight different bank groups.
constexpr int kInW = kInCols + 4;
constexpr int kRowW = kProbeTw + 4;
// Shared memory of a block: the input tile, the row-blurred tile and the
// block tree, 45,504 B, under the 48 KB of static shared memory; five
// blocks of it fit an SM's 228 KB (1 KB reserved a block).
constexpr int kSmemBytes = (kHaloH * (kInW + kRowW) + kPThreads) * (int)sizeof(float);
constexpr int kMinBlocks = 5;

// Input tile: 16-byte chunks, kInCols / 4 a row.
constexpr int kRowChunks = kInCols / 4;
constexpr int kChunks = kHaloH * kRowChunks;

// Row pass.  A task blurs N consecutive outputs of one row: the lanes of a
// warp take 32 consecutive rows at one column, each walking its row in
// registers.  The tile's first kProbeTh input rows take tasks of kRowN
// outputs (each thread the same number), the last 10 rows tasks of
// kHaloN outputs (one task a thread at most).
constexpr int kRowN = 32;
constexpr int kHaloN = 8;
constexpr int kMainTasks = kProbeTh * (kProbeTw / kRowN);
constexpr int kMainIters = kMainTasks / kPThreads;
constexpr int kHaloTasks = 2 * kProbeRadius * (kProbeTw / kHaloN);

static_assert(128 % kProbeTh == 0 && 512 % kProbeTw == 0, "a 128x512 region tile is whole blocks");
static_assert(kProbeTw % 32 == 0 && kProbeTh % kColRows == 0 && kPThreads % 32 == 0, "column pass");
static_assert(kRowN % 4 == 0 && kProbeTw % kRowN == 0 && kProbeTh % 32 == 0, "main row tasks");
static_assert(kMainTasks % kPThreads == 0, "each thread the same number of main row tasks");
static_assert(kHaloTasks <= kPThreads, "one halo task a thread at most");
static_assert(kInW % 32 == 20 && kRowW % 32 == 4, "bank-spread row strides");
static_assert(kSmemBytes <= 48 * 1024 && kMinBlocks * (kSmemBytes + 1024) <= 228 * 1024, "5 blocks an SM");

// The row blur of input row r's outputs col0 .. col0 + N - 1 (col0 a
// multiple of 4) into row r of the row-blurred tile: the 16-byte chunks
// of input columns col0 .. col0 + N + 15 (output col0 + j takes input column
// col0 + j + 3 + k), each output summed over k = 0..10 in order from 0.
template <int N>
__device__ __forceinline__ void row_task(const float* __restrict__ in, float* __restrict__ rows, int r,
                                         int col0, const float (&t)[kProbeTaps]) {
  const float4* ip = reinterpret_cast<const float4*>(in + r * kInW + col0);
  float v[N + 16];
#pragma unroll
  for (int m = 0; m < N / 4 + 4; ++m) {
    const float4 c = ip[m];
    v[4 * m] = c.x;
    v[4 * m + 1] = c.y;
    v[4 * m + 2] = c.z;
    v[4 * m + 3] = c.w;
  }
  float4* op = reinterpret_cast<float4*>(rows + r * kRowW + col0);
#pragma unroll
  for (int m = 0; m < N / 4; ++m) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kProbeTaps; ++k) s = fmaf(t[k], v[4 * m + j + kInOff - kProbeRadius + k], s);
      o[j] = s;
    }
    op[m] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// grid: (region_w / kProbeTw, region_h / kProbeTh, planes), block: kPThreads
// (1-D).
__global__ void __launch_bounds__(kPThreads, kMinBlocks)
blur_probe_kernel(const float* __restrict__ x, int h, int w, int passes,
                  const float* __restrict__ taps, float* __restrict__ parts) {
  __shared__ __align__(16) float in[kHaloH * kInW];
  __shared__ __align__(16) float rows[kHaloH * kRowW];
  __shared__ float red[1][kPThreads];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kProbeTh, c0 = blockIdx.x * kProbeTw;
  const size_t plane = blockIdx.z;
  const float* src = x + plane * h * w;

  // Input tile: rows r0-5 .. r0+kProbeTh+4, columns c0-8 .. c0+kProbeTw+7,
  // zeros outside the plane, by asynchronous copies straight into shared
  // memory (a copy of 0 bytes zero-fills).  Where every column lies inside
  // the plane on 16-byte boundaries (the interior of a plane whose width is
  // a multiple of 4), a chunk is one 16-byte copy; elsewhere one copy a
  // sample.
  const bool interior = c0 >= kInOff && c0 - kInOff + kInCols <= w && w % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = tid; i < kChunks; i += kPThreads) {
    const int r = i / kRowChunks, q = i - r * kRowChunks;
    const int gr = r0 - kProbeRadius + r, gc = c0 - kInOff + 4 * q;
    const bool row_in = gr >= 0 && gr < h;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(in + r * kInW + 4 * q);
    if (interior) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   ::"r"(dst), "l"(src + (row_in ? (size_t)gr * w + gc : 0)), "r"(row_in ? 16 : 0));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in_plane = row_in && gc + e >= 0 && gc + e < w;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     ::"r"(dst + 4 * e), "l"(src + (in_plane ? (size_t)gr * w + gc + e : 0)), "r"(in_plane ? 4 : 0));
      }
    }
  }
  float t[kProbeTaps];
#pragma unroll
  for (int k = 0; k < kProbeTaps; ++k) t[k] = __ldg(taps + k);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int cc = tid % (kProbeTw / 4), o0 = (tid / (kProbeTw / 4)) * kColRows;
  float acc = 0.0f;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    // Row pass: task i of the first kProbeTh rows is row i % kProbeTh,
    // outputs (i / kProbeTh) * kRowN ..; halo task i (i < kHaloTasks) row
    // kProbeTh + i % 10, outputs (i / 10) * kHaloN ...
#pragma unroll
    for (int n = 0; n < kMainIters; ++n) {
      const int i = tid + n * kPThreads;
      row_task<kRowN>(in, rows, i % kProbeTh, (i / kProbeTh) * kRowN, t);
    }
    if (tid < kHaloTasks) {
      row_task<kHaloN>(in, rows, kProbeTh + tid % (2 * kProbeRadius), (tid / (2 * kProbeRadius)) * kHaloN, t);
    }
    __syncthreads();

    // Column pass: kColRows x 4 outputs from a window of kColWin rows,
    // added to acc row by row, column by column.
    const float4* rp = reinterpret_cast<const float4*>(rows + o0 * kRowW) + cc;
    float4 c[kColWin];
#pragma unroll
    for (int j = 0; j < kColWin; ++j) c[j] = rp[j * (kRowW / 4)];
#pragma unroll
    for (int i = 0; i < kColRows; ++i) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kProbeTaps; ++k) {
        s[0] = fmaf(t[k], c[i + k].x, s[0]);
        s[1] = fmaf(t[k], c[i + k].y, s[1]);
        s[2] = fmaf(t[k], c[i + k].z, s[2]);
        s[3] = fmaf(t[k], c[i + k].w, s[3]);
      }
      acc += s[0];
      acc += s[1];
      acc += s[2];
      acc += s[3];
    }
    __syncthreads();  // the next repetition overwrites rows
  }

  const float v[1] = {acc};
  block_partials<1, kPThreads>(v, red, parts, plane);
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
// region_h x region_w (whole kProbeTh x kProbeTw tiles): the caller sizes
// `parts` as planes * nblk floats.
int tm_blur_probe_blocks(int region_h, int region_w) {
  const dim3 g = probe_grid(region_h, region_w, 1);
  return (int)(g.x * g.y);
}

// What blur_probe_kernel takes on this card: out[0] registers per thread,
// out[1] static shared memory per block in bytes, out[2] resident blocks per
// SM, out[3] local memory per thread in bytes (spills).
int tm_blur_probe_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blur_probe_kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blur_probe_kernel, kPThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// The replacement of blur_only (tools/kernel_dissect.py:106): x (planes, h,
// w) -> out (planes, 8, 8), out[p, 0, 0] = the sum over passes of the blurred
// plane over rows [0, region_h) x columns [0, region_w), the image
// zero-extended.  planes at most 65535; the region whole kProbeTh x kProbeTw
// tiles, else cudaErrorInvalidValue and no launch.
int tm_blur_probe(const float* x, int planes, int h, int w, int region_h, int region_w,
                  int passes, const float* taps, float* parts, float* out, void* stream) {
  if (region_h <= 0 || region_w <= 0 || region_h % kProbeTh || region_w % kProbeTw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = probe_grid(region_h, region_w, planes);
  blur_probe_kernel<<<grid, kPThreads, 0, s>>>(x, h, w, passes, taps, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_reduce_kernel<<<planes, kReduceThreads, 0, s>>>(parts, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
