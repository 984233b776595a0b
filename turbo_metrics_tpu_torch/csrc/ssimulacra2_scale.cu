// SSIMULACRA2 pyramid levels on Hopper (sm_90a): conversion, XYB, the
// 11-tap separable blur of four quantities, the error maps and their sums.
//
// Built by ops/kernels/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a,
// one object per source, linked into one shared library with a plain C
// interface, loaded with ctypes).  Every entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so that a refused
// launch is reported where it happened.
//
// Replaces five TPU kernels of the JAX package:
//   * turbo_metrics_tpu/ops/pallas/scale_stats.py fused_scale0_yuv_pallas
//     (scale 0 straight from YUV 4:2:0) = tm_yuv420_to_xyb + tm_level_sums;
//   * turbo_metrics_tpu/ops/pallas/scale_stats.py fused_scale_pallas_v4
//     (one level from linear RGB, next level emitted) = tm_rgb_to_xyb +
//     tm_level_sums, once;
//   * turbo_metrics_tpu/ops/pallas/scale_tail.py fused_pyramid_tail_pallas
//     (levels 1..5) = tm_rgb_to_xyb + tm_level_sums, once per level;
//   * turbo_metrics_tpu/ops/pallas/scale_stats_legacy.py scale_sums_pallas
//     (one level's sums from two XYB tensors) = tm_level_sums_pair;
//   * turbo_metrics_tpu/ops/pallas/scale_stats_legacy.py fused_scale_pallas_v3
//     (one level's sums from two linear-RGB tensors, no emission; also the
//     function of fused_scale_pallas, v2) = tm_rgb_pair_to_xyb +
//     tm_level_sums.
// And one pass with no TPU counterpart (the JAX package converts packed sRGB
// with jnp): scale 0's conversion pass straight from packed integer RGB
// codes, tm_srgb_pair_to_xyb (+ tm_level_sums), kernel 1's sibling for sRGB.
// The per-pixel arithmetic and the fused level pass of one tile (level_tile)
// live in ssimulacra2_level.cuh, shared with the persistent tail kernel of
// ssimulacra2_tail.cu (#4), which runs the same tiles in one launch.
//
// A level is two passes: the conversion pass (YUV or linear RGB -> XYB, and
// the next level's 2x2 mean) and the fused level pass (level_tile_kernel:
// both blur passes, the maps and the per-tile partials), then the f64
// reduction of the partials.
//
// What bounds the fused level pass on this card: its f32 work (per pixel
// pair and channel 11 row taps of 7 operations over 1.31x the rows, for the
// halo, 44 column multiply-adds, ~25 for the maps) and the shared-memory
// loads that feed it (22 per row-pass output), about evenly; device memory
// is no longer in the way: it reads the 24 bytes of XYB per pixel pair once
// (plus halo rows and columns, mostly from L2) and writes only partials.
// What its design does about it:
//   * one block per 32x32 output tile of one (batch, channel) plane; the
//     four row-blurred planes of the tile live in shared memory
//     (4 x 42 x 32 f32) and never reach device memory;
//   * the input tiles of both images (42 rows x 48 columns) are read with
//     16-byte loads, eight per thread, all issued before the first is
//     stored; a chunk that is not aligned or hangs over the plane's edge
//     (widths such as 99 or 683) is read one float at a time, zeros
//     outside the plane (the zero-extended border).  On an H100, 4-byte
//     loads throughout made the kernel 23% slower;
//   * no load stage overlaps the compute within a block: at 37.6 KB of
//     static shared memory and 128 threads, five blocks share an SM, so one
//     block's loads overlap the others' compute (a two-stage cp.async ring
//     over the three channels of one image was 6% slower on an H100 at
//     1080p and up to 2x slower on levels of a few dozen tiles);
//   * register blocking in the column pass: each thread computes one column
//     of one 32x8 sub-tile, eight outputs from an 18-row window (2.25 shared
//     loads per output and quantity instead of 11);
//   * each warp owns one 32x8 sub-tile, so level.cuh's fixed partial tree
//     runs in registers (the three row strides inside a thread) and warp
//     shuffles (the five column strides): the same pairs in the same order
//     as tile_partials, so the sums equal the two-pass design's bit for bit
//     and #4's (ssimulacra2_tail.cu).
// The row pass reads 11 shared values per output: its loads are the next
// limit.
//
// The conversion stays a pass of its own: fusing it into the tile would save
// writing and reading XYB (24 bytes per pixel pair each way), but the tile's
// 1.72x halo area would recompute the cube roots and, for kernel 1, the
// EOTF, and that conversion is bound by operations already.
//
// Layouts (all contiguous):
//   luma   (2, B, h, w)            u8 or u16, image 0 = reference, 1 = distorted
//   chroma (2, B, ch, cw, 2)        same type, (Cb, Cr) pairs, ch = ceil(h/2)
//   codes  (B, h, w, 3) x 2         u8 or u16 packed RGB, reference and distorted
//   table  (2^16 or 2^8)            f32 linear light of every code of the type
//   level  (2, B, 3, h, w)          f32 linear RGB
//   xyb    (2, B, 3, h, w)          f32 positive-shifted XYB (scratch)
//   parts  (B*3, nblk, 6)           f32 per-32x8-tile partial sums
//   sums   (B, [levels,] 3, 6)      f32 (d, d^4, art, art^4, det, det^4)

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "level.cuh"
#include "ssimulacra2_level.cuh"

namespace {

// ---------------------------------------------------------------------------
// Conversion pass of scale 0: one thread per 2x2 luma quad.  Converts YUV
// 4:2:0 to clamped linear RGB, writes XYB for the quad's pixels that lie
// inside the image, and writes the quad's mean of linear RGB as the next
// level's pixel.  A quad that hangs over an odd edge replicates the last
// row/column (ops/downscale.py), so the mean of the replicated samples is
// exact.
// grid: (ceil(wq/kBx), ceil(hq/kBy), 2*B); TF the transfer function
// (colorspace.cuh).
// ---------------------------------------------------------------------------
template <typename T, int TF>
__global__ void __launch_bounds__(kThreads)
yuv420_to_xyb_kernel(const T* __restrict__ luma, const T* __restrict__ chroma,
                     int h, int w, ConvParams p, const float* __restrict__ opsin,
                     float* __restrict__ xyb, float* __restrict__ next) {
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= hq || qj >= wq) return;
  const size_t img = blockIdx.z;  // image * B + batch
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)hq * wq;
  float o[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) o[k] = __ldg(opsin + k);

  const T* cp = chroma + (img * nq + (size_t)qi * wq + qj) * 2;
  const ChromaTerms t = chroma_terms((float)cp[0], (float)cp[1], p);

  const T* yp = luma + img * npx;
  float* xp = xyb + img * 3 * npx;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int r = min(2 * qi + dy, h - 1);
      const int c = min(2 * qj + dx, w - 1);
      float rgb[3];
      pixel_rgb<TF>((float)yp[(size_t)r * w + c], t, p, rgb);
      acc[0] += rgb[0];
      acc[1] += rgb[1];
      acc[2] += rgb[2];
      if (2 * qi + dy < h && 2 * qj + dx < w) {
        const size_t at = (size_t)r * w + c;
        to_xyb(rgb[0], rgb[1], rgb[2], o, xp + at, xp + npx + at, xp + 2 * npx + at);
      }
    }
  }
  if (next != nullptr) {
    float* np_ = next + img * 3 * nq + (size_t)qi * wq + qj;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) np_[ch * nq] = acc[ch] * 0.25f;
  }
}

// ---------------------------------------------------------------------------
// Conversion pass of levels 1..5: the same quad pass from a linear-RGB
// level, the reference's B images at ref and the distorted one's at dis (two
// tensors, or the two halves of one pair buffer).
// grid: (ceil(wq/kBx), ceil(hq/kBy), 2*B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
rgb_to_xyb_kernel(const float* __restrict__ ref, const float* __restrict__ dis, int batch, int h,
                  int w, const float* __restrict__ opsin, float* __restrict__ xyb,
                  float* __restrict__ next) {
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= hq || qj >= wq) return;
  const int img = blockIdx.z;  // image * B + batch
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)hq * wq;
  float o[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) o[k] = __ldg(opsin + k);
  const float* src = img < batch ? ref + (size_t)img * 3 * npx : dis + (size_t)(img - batch) * 3 * npx;
  rgb_quad<Src::kReadOnly>(
      src, h, w, qi, qj, o, xyb + (size_t)img * 3 * npx,
      next != nullptr ? next + (size_t)img * 3 * nq + (size_t)qi * wq + qj : nullptr, nq);
}

// ---------------------------------------------------------------------------
// Conversion pass of scale 0 from packed integer RGB: one thread per 2x2
// quad, as yuv420_to_xyb_kernel.  The reference's B images of interleaved
// codes at ref, the distorted one's at dis; each code maps through table,
// the linear light of every code of T that the plain route computes
// (ops/kernels/scale_stats.py code_table: colorspace.srgb_to_linear of
// torch.arange on the device), so every linear value, and then every XYB
// value and mean, equals rgb_quad's on the plain route's pair buffer bit
// for bit.  The EOTF of colorspace.cuh (lg2/ex2.approx) would not.  The
// quad's pixels are summed ((a+b)+c)+d in rgb_quad's order.
//   * u8: the 256-entry table (1 KB) copied into shared memory by each
//     block (one entry per thread), looked up there;
//   * u16: the 65536-entry table (256 KB) read from device memory, where it
//     stays resident in L2.
// What bounds it on this card: its bytes, ~0.10 GB of u8 codes in and ~0.50
// GB of XYB and level 1 out per 1080p B=8 pair batch (~0.18 ms at 3.35
// TB/s), and its cube roots, the same three per pixel as kernel 1's
// conversion pass: 0.290 ms of device time on an H100, as kernel 1's pass
// (0.65 ms at u16, its table read from L2).  Each thread
// reads its quad's two rows of 6 (u8) or 12 (u16) bytes one code at a time:
// a warp's codes are 192 (384) consecutive bytes a row, so the loads
// coalesce whatever the row's alignment.
// grid: (ceil(wq/kBx), ceil(hq/kBy), 2*B), block: (kBx, kBy).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
srgb_to_xyb_kernel(const T* __restrict__ ref, const T* __restrict__ dis, int batch, int h, int w,
                   const float* __restrict__ table, const float* __restrict__ opsin,
                   float* __restrict__ xyb, float* __restrict__ next) {
  constexpr bool kShared = sizeof(T) == 1;
  static_assert(!kShared || kThreads == 256, "one table entry per thread");
  __shared__ float lut[kShared ? 256 : 1];
  if (kShared) {
    const int t = threadIdx.y * kBx + threadIdx.x;
    lut[t] = __ldg(table + t);
    __syncthreads();
  }
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= hq || qj >= wq) return;
  const int img = blockIdx.z;  // image * B + batch
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)hq * wq;
  float o[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) o[k] = __ldg(opsin + k);
  const T* src = img < batch ? ref + (size_t)img * 3 * npx : dis + (size_t)(img - batch) * 3 * npx;
  float* xp = xyb + (size_t)img * 3 * npx;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int r = min(2 * qi + dy, h - 1);
      const int c = min(2 * qj + dx, w - 1);
      const size_t at = (size_t)r * w + c;
      const T* px = src + 3 * at;
      float v[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const unsigned code = __ldg(px + ch);
        v[ch] = kShared ? lut[code] : __ldg(table + code);
      }
      acc[0] += v[0];
      acc[1] += v[1];
      acc[2] += v[2];
      if (2 * qi + dy < h && 2 * qj + dx < w) {
        to_xyb(v[0], v[1], v[2], o, xp + at, xp + npx + at, xp + 2 * npx + at);
      }
    }
  }
  if (next != nullptr) {
    float* np_ = next + (size_t)img * 3 * nq + (size_t)qi * wq + qj;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) np_[ch * nq] = acc[ch] * 0.25f;
  }
}

// ---------------------------------------------------------------------------
// The fused level pass (level_tile in ssimulacra2_level.cuh): one block per
// 32x32 output tile of plane blockIdx.z (b*3 + ch), the columns [clo, chi)
// summed.
// grid: (ceil(w/32), ceil(h/32), B*3), block: kTileThreads (1-D).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTileThreads)
level_tile_kernel(const float* __restrict__ xa, const float* __restrict__ xb, int h, int w,
                  int clo, int chi, const float* __restrict__ taps, float* __restrict__ parts) {
  __shared__ __align__(16) float smem[kTileSmemFloats];
  level_tile<Src::kReadOnly>(xa, xb, h, w, clo, chi, taps, parts, blockIdx.x, blockIdx.y,
                             blockIdx.z, smem);
}

int level_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// Blur, maps and sums of one level from the reference's XYB xa and the
// distorted one's xb, B*3 planes each; the sums over the columns [clo, chi)
// (0 and w: the whole plane).
int level_sums(const float* xa, const float* xb, int batch, int h, int w, int clo, int chi,
               const float* taps, float* parts, float* sums, int sums_bstride, cudaStream_t s) {
  if (clo < 0 || clo >= chi || chi > w) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, 3 * batch);
  level_tile_kernel<<<grid, kTileThreads, 0, s>>>(xa, xb, h, w, clo, chi, taps, parts);
  reduce_parts_kernel<6><<<3 * batch, kReduceThreads, 0, s>>>(parts, level_blocks(h, w), sums,
                                                               sums_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of 32x8-tile partials tm_level_sums writes for each (batch,
// channel) plane of an h x w level: the caller sizes `parts` as
// B*3*nblk*6 floats.
int tm_level_blocks(int h, int w) { return level_blocks(h, w); }

// What the fused level kernel takes on this card: out[0] registers per
// thread, out[1] shared memory per block in bytes, out[2] resident blocks
// per SM.
int tm_level_tile_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, level_tile_kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_tile_kernel, kTileThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  return 0;
}

// Scale-0 conversion pass: with tm_level_sums, the replacement of
// fused_scale0_yuv_pallas (turbo_metrics_tpu/ops/pallas/scale_stats.py:1985).
// luma (2,B,h,w), chroma (2,B,ceil(h/2),ceil(w/2),2), u16 when is16 else u8;
// xyb (2,B,3,h,w); next (2,B,3,ceil(h/2),ceil(w/2)) or null when no further
// level is needed.  Bound by operations (the EOTF and three cube roots per
// pixel), not by its 3 bytes in and 24 + 6 bytes out per pixel pair.
int tm_yuv420_to_xyb(const void* luma, const void* chroma, int is16, int batch, int h, int w,
                     float y_coeff, float r_coeff, float b_coeff, float g_coeff1,
                     float g_coeff2, float minimum, float neutral, int transfer,
                     const float* opsin, float* xyb, float* next, void* stream) {
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral};
  const dim3 grid = quad_grid(h, w, 2 * batch);
  const dim3 block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch_transfer(transfer, [&](auto tf) {
    constexpr int TF = decltype(tf)::value;
    if (is16) {
      yuv420_to_xyb_kernel<uint16_t, TF><<<grid, block, 0, s>>>(
          static_cast<const uint16_t*>(luma), static_cast<const uint16_t*>(chroma), h, w, p, opsin,
          xyb, next);
    } else {
      yuv420_to_xyb_kernel<uint8_t, TF><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(luma), static_cast<const uint8_t*>(chroma), h, w, p, opsin,
          xyb, next);
    }
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Scale-0 conversion pass from packed integer RGB: with tm_level_sums, kernel
// 1's sibling for sRGB sources; it replaces no TPU kernel (the JAX package
// converts sRGB with jnp).  ref, dis (B,h,w,3) codes, u16 when is16 else u8;
// table the f32 linear light of every code of that type (65536 or 256
// entries); xyb (2,B,3,h,w); next (2,B,3,ceil(h/2),ceil(w/2)) or null.
int tm_srgb_pair_to_xyb(const void* ref, const void* dis, int is16, int batch, int h, int w,
                        const float* table, const float* opsin, float* xyb, float* next,
                        void* stream) {
  const dim3 grid = quad_grid(h, w, 2 * batch);
  const dim3 block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is16) {
    srgb_to_xyb_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(ref), static_cast<const uint16_t*>(dis), batch, h, w, table,
        opsin, xyb, next);
  } else {
    srgb_to_xyb_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(dis), batch, h, w, table,
        opsin, xyb, next);
  }
  return (int)cudaGetLastError();
}

// The level conversion pass from two (B,3,h,w) tensors, ref and dis, into the pair
// buffers xyb (2,B,3,h,w) and next (or null): with tm_level_sums, the
// replacement of fused_scale_pallas_v3 (turbo_metrics_tpu/ops/pallas/
// scale_stats_legacy.py:644) and of fused_scale_pallas (v2, :367).
int tm_rgb_pair_to_xyb(const float* ref, const float* dis, int batch, int h, int w,
                       const float* opsin, float* xyb, float* next, void* stream) {
  rgb_to_xyb_kernel<<<quad_grid(h, w, 2 * batch), dim3(kBx, kBy), 0,
                      static_cast<cudaStream_t>(stream)>>>(ref, dis, batch, h, w, opsin, xyb,
                                                           next);
  return (int)cudaGetLastError();
}

// Level conversion pass: with tm_level_sums, once per level, the replacement
// of fused_pyramid_tail_pallas (turbo_metrics_tpu/ops/pallas/scale_tail.py:243),
// and once, the replacement of fused_scale_pallas_v4 (scale_stats.py:2552).
// rgb (2,B,3,h,w) linear RGB: tm_rgb_pair_to_xyb on its two halves.
int tm_rgb_to_xyb(const float* rgb, int batch, int h, int w, const float* opsin, float* xyb,
                  float* next, void* stream) {
  return tm_rgb_pair_to_xyb(rgb, rgb + (size_t)batch * 3 * h * w, batch, h, w, opsin, xyb, next,
                            stream);
}

// The fused level pass and the reduction (shared by the replacements
// above): xyb (2,B,3,h,w) -> sums[b*sums_bstride + ch*6 + k] over the
// owned columns [clo, chi) (0 and w: the whole level; a column strip's
// window, parallel/mesh.py).  parts holds B*3*tm_level_blocks(h,w)*6
// floats; no other scratch.
int tm_level_sums(const float* xyb, int batch, int h, int w, int clo, int chi, const float* taps,
                  float* parts, float* sums, int sums_bstride, void* stream) {
  return level_sums(xyb, xyb + (size_t)batch * 3 * h * w, batch, h, w, clo, chi, taps, parts,
                    sums, sums_bstride, static_cast<cudaStream_t>(stream));
}

// The same from two (B,3,h,w) XYB tensors, xyb1 (reference) and xyb2
// (distorted), without stacking them: the replacement of scale_sums_pallas
// (turbo_metrics_tpu/ops/pallas/scale_stats_legacy.py:172).
int tm_level_sums_pair(const float* xyb1, const float* xyb2, int batch, int h, int w, int clo,
                       int chi, const float* taps, float* parts, float* sums, int sums_bstride,
                       void* stream) {
  return level_sums(xyb1, xyb2, batch, h, w, clo, chi, taps, parts, sums, sums_bstride,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
