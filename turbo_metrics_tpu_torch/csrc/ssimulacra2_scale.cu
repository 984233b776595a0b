// SSIMULACRA2 pyramid levels on Hopper (sm_90a): conversion, XYB, the
// 11-tap separable blur of four quantities, the error maps and their sums.
//
// Built by ops/kernels/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a,
// one object per source, linked into one shared library with a plain C
// interface, loaded with ctypes).  Every entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so that a refused
// launch is reported where it happened.
//
// Replaces three TPU kernels of the JAX package:
//   * turbo_metrics_tpu/ops/pallas/scale_stats.py fused_scale0_yuv_pallas
//     (scale 0 straight from YUV 4:2:0) = tm_yuv420_to_xyb + tm_level_sums;
//   * turbo_metrics_tpu/ops/pallas/scale_stats.py fused_scale_pallas_v4
//     (one level from linear RGB, next level emitted) = tm_rgb_to_xyb +
//     tm_level_sums, once;
//   * turbo_metrics_tpu/ops/pallas/scale_tail.py fused_pyramid_tail_pallas
//     (levels 1..5) = tm_rgb_to_xyb + tm_level_sums, once per level.
//
// What bounds them on this card: the algorithm's floor is its f32 work (about
// 730 operations per pixel pair and level: XYB, two 11-tap passes over four
// planes per channel, the maps) rather than its few bytes in and out, but this
// design's own device-memory traffic is larger still: ~10 f32 planes read or
// written per pixel pair (XYB x2, four row-blurred planes written then read
// back, the next level).  What the design does about it: nothing yet.
// Each pass is a plain thread-per-pixel loop over global memory; shared-memory
// row tiles, fusing the row and column passes so the blurred planes never
// reach device memory, TMA loads and CUDA graphs are for later work.
//
// Layouts (all contiguous):
//   luma   (2, B, h, w)            u8 or u16, image 0 = reference, 1 = distorted
//   chroma (2, B, ch, cw, 2)        same type, (Cb, Cr) pairs, ch = ceil(h/2)
//   level  (2, B, 3, h, w)          f32 linear RGB
//   xyb    (2, B, 3, h, w)          f32 positive-shifted XYB (scratch)
//   tmp    (4, B*3, h, w)           f32 row-blurred x1, x2, (x1-x2)^2, x1*x2
//   parts  (B*3, nblk, 6)           f32 per-block partial sums
//   sums   (B, [levels,] 3, 6)      f32 (d, d^4, art, art^4, det, det^4)

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "level.cuh"

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

// Newton-refined cube root of max(v, 0) (ops/xyb.py _cbrt).
__device__ __forceinline__ float cbrt_nr(float v) {
  v = fmaxf(v, 0.0f);
  const float y0 = cbrtf(v);
  const float refined = (2.0f * y0 + v / fmaxf(y0 * y0, 1e-30f)) * (float)(1.0 / 3.0);
  return v > 0.0f ? refined : 0.0f;
}

// o: 9 opsin matrix entries (row-major), bias, bias root.
__device__ __forceinline__ void to_xyb(float r, float g, float b, const float* o,
                                       float* x_out, float* y_out, float* b_out) {
  const float rmix = o[0] * r + o[1] * g + o[2] * b + o[9];
  const float gmix = o[3] * r + o[4] * g + o[5] * b + o[9];
  const float bmix = o[6] * r + o[7] * g + o[8] * b + o[9];
  const float rg = cbrt_nr(rmix) - o[10];
  const float gr = cbrt_nr(gmix) - o[10];
  const float bb = cbrt_nr(bmix) - o[10];
  const float x = 0.5f * (rg - gr);
  const float y = 0.5f * (rg + gr);
  *x_out = x * 14.0f + 0.42f;
  *y_out = y + 0.01f;
  *b_out = bb - y + 0.55f;
}

// ---------------------------------------------------------------------------
// Launch 1 of scale 0: one thread per 2x2 luma quad.  Converts YUV 4:2:0 to
// clamped linear RGB, writes XYB for the quad's pixels that lie inside the
// image, and writes the quad's mean of linear RGB as the next level's pixel.
// A quad that hangs over an odd edge replicates the last row/column
// (ops/downscale.py), so the mean of the replicated samples is exact.
// grid: (ceil(wq/kBx), ceil(hq/kBy), 2*B)
// ---------------------------------------------------------------------------
template <typename T>
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
      pixel_rgb((float)yp[(size_t)r * w + c], t, p, rgb);
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
// Launch 1 of levels 1..5: the same quad pass from a linear-RGB level.
// grid: (ceil(wq/kBx), ceil(hq/kBy), 2*B)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
rgb_to_xyb_kernel(const float* __restrict__ rgb, int h, int w, const float* __restrict__ opsin,
                  float* __restrict__ xyb, float* __restrict__ next) {
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= hq || qj >= wq) return;
  const size_t img = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)hq * wq;
  float o[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) o[k] = __ldg(opsin + k);

  const float* src = rgb + img * 3 * npx;
  float* xp = xyb + img * 3 * npx;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int r = min(2 * qi + dy, h - 1);
      const int c = min(2 * qj + dx, w - 1);
      const size_t at = (size_t)r * w + c;
      const float v[3] = {src[at], src[npx + at], src[2 * npx + at]};
      acc[0] += v[0];
      acc[1] += v[1];
      acc[2] += v[2];
      if (2 * qi + dy < h && 2 * qj + dx < w) {
        to_xyb(v[0], v[1], v[2], o, xp + at, xp + npx + at, xp + 2 * npx + at);
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
// Launch 2: horizontal 11-tap pass of x1, x2, (x1-x2)^2 and x1*x2 for every
// (batch, channel) plane; samples outside [0, w) count as zero.  The SSIM
// map needs s11 and s22 only through s11 + s22 - 2 s12 = blur((x1-x2)^2), so
// four blurred planes suffice (ops/ssim_maps.py ssim_map).
// grid: (ceil(w/kBx), ceil(h/kBy), B*3)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const float* __restrict__ xyb, int planes, int h, int w,
                 const float* __restrict__ taps, float* __restrict__ tmp) {
  const int c = blockIdx.x * kBx + threadIdx.x;
  const int r = blockIdx.y * kBy + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t npx = (size_t)h * w;
  const size_t plane = blockIdx.z;
  const float* a = xyb + plane * npx + (size_t)r * w;                  // reference
  const float* b = xyb + ((size_t)planes + plane) * npx + (size_t)r * w;  // distorted
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int cc = c + k - kRadius;
    if (cc >= 0 && cc < w) {
      const float t = __ldg(taps + k);
      const float av = a[cc], bv = b[cc];
      s[0] += t * av;
      s[1] += t * bv;
      const float dv = av - bv;
      s[2] += t * (dv * dv);
      s[3] += t * (av * bv);
    }
  }
  const size_t at = plane * npx + (size_t)r * w + c;
  const size_t qstride = (size_t)planes * npx;
#pragma unroll
  for (int q = 0; q < 4; ++q) tmp[q * qstride + at] = s[q];
}

// ---------------------------------------------------------------------------
// Launch 3: vertical 11-tap pass (zero outside [0, h)), the SSIM, artifact
// and detail-loss maps, and per-block f32 partial sums of the six reduced
// quantities (level.cuh block_partials; launch 4 is level.cuh's
// reduce_parts_kernel<6>).
// grid: (ceil(w/kBx), ceil(h/kBy), B*3)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
blur_cols_maps_kernel(const float* __restrict__ xyb, const float* __restrict__ tmp, int planes,
                      int h, int w, const float* __restrict__ taps, float* __restrict__ parts) {
  __shared__ float red[6][kThreads];
  const int c = blockIdx.x * kBx + threadIdx.x;
  const int r = blockIdx.y * kBy + threadIdx.y;
  const size_t npx = (size_t)h * w;
  const size_t plane = blockIdx.z;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (r < h && c < w) {
    const size_t qstride = (size_t)planes * npx;
    const float* base = tmp + plane * npx + c;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int rr = r + k - kRadius;
      if (rr >= 0 && rr < h) {
        const float t = __ldg(taps + k);
        const float* row = base + (size_t)rr * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] += t * row[q * qstride];
      }
    }
    const float mu1 = s[0], mu2 = s[1], sdd = s[2], s12 = s[3];
    const size_t at = (size_t)r * w + c;
    const float i1 = xyb[plane * npx + at];
    const float i2 = xyb[((size_t)planes + plane) * npx + at];

    // 1 - (1 - md^2) num_s / denom_s with denom_s = num_s + var_d, written
    // from the variance of x1 - x2 (well conditioned for close images).
    const float c2 = 0.0009f;
    const float md = mu1 - mu2;
    const float num_s = 2.0f * (s12 - mu1 * mu2) + c2;
    const float var_d = sdd - md * md;
    const float d = fmaxf((var_d + md * md * num_s) / (num_s + var_d), 0.0f);

    const float ea = fabsf(i2 - mu2);
    const float eb = fabsf(i1 - mu1);
    const float d1 = (ea - eb) / (1.0f + eb);
    const float art = fmaxf(d1, 0.0f);
    const float det = fmaxf(-d1, 0.0f);
    const float d2 = d * d, art2 = art * art, det2 = det * det;
    v[0] = d;
    v[1] = d2 * d2;
    v[2] = art;
    v[3] = art2 * art2;
    v[4] = det;
    v[5] = det2 * det2;
  }
  block_partials<6>(v, red, parts, plane);
}

}  // namespace

extern "C" {

// Number of per-block partials tm_level_sums writes for each (batch, channel)
// plane of an h x w level: the caller sizes `parts` as B*3*nblk*6 floats.
int tm_level_blocks(int h, int w) {
  const dim3 g = pixel_grid(h, w, 1);
  return (int)(g.x * g.y);
}

// Scale-0 conversion pass: with tm_level_sums, the replacement of
// fused_scale0_yuv_pallas (turbo_metrics_tpu/ops/pallas/scale_stats.py:1985).
// luma (2,B,h,w), chroma (2,B,ceil(h/2),ceil(w/2),2), u16 when is16 else u8;
// xyb (2,B,3,h,w); next (2,B,3,ceil(h/2),ceil(w/2)) or null when no further
// level is needed.  Bound by device memory: 3 bytes in, 24 + 6 bytes out per
// pixel pair; nothing done about it yet (the XYB planes could stay on chip if
// this pass were fused with the row blur).
int tm_yuv420_to_xyb(const void* luma, const void* chroma, int is16, int batch, int h, int w,
                     float y_coeff, float r_coeff, float b_coeff, float g_coeff1,
                     float g_coeff2, float minimum, float neutral, int transfer,
                     const float* opsin, float* xyb, float* next, void* stream) {
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral, transfer};
  const dim3 grid = quad_grid(h, w, 2 * batch);
  const dim3 block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is16) {
    yuv420_to_xyb_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(luma), static_cast<const uint16_t*>(chroma), h, w, p, opsin,
        xyb, next);
  } else {
    yuv420_to_xyb_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(luma), static_cast<const uint8_t*>(chroma), h, w, p, opsin,
        xyb, next);
  }
  return (int)cudaGetLastError();
}

// Level conversion pass: with tm_level_sums, once per level, the replacement
// of fused_pyramid_tail_pallas (turbo_metrics_tpu/ops/pallas/scale_tail.py:243),
// and once, the replacement of fused_scale_pallas_v4 (scale_stats.py:2552).
// rgb (2,B,3,h,w) linear RGB.  Bound by device memory like the scale-0 pass.
int tm_rgb_to_xyb(const float* rgb, int batch, int h, int w, const float* opsin, float* xyb,
                  float* next, void* stream) {
  rgb_to_xyb_kernel<<<quad_grid(h, w, 2 * batch), dim3(kBx, kBy), 0,
                      static_cast<cudaStream_t>(stream)>>>(rgb, h, w, opsin, xyb, next);
  return (int)cudaGetLastError();
}

// Blur, maps and sums of one level (shared by both replacements): xyb
// (2,B,3,h,w) -> sums[b*sums_bstride + ch*6 + k].  tmp holds 4*B*3*h*w
// floats, parts B*3*tm_level_blocks(h,w)*6.  Bound by device memory: the four
// row-blurred planes make a round trip through it (32 bytes written and read
// per pixel and channel); fusing the two passes over shared-memory row tiles
// is the first later optimisation.
int tm_level_sums(const float* xyb, int batch, int h, int w, const float* taps, float* tmp,
                  float* parts, float* sums, int sums_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = 3 * batch;
  const dim3 grid = pixel_grid(h, w, planes);
  const dim3 block(kBx, kBy);
  blur_rows_kernel<<<grid, block, 0, s>>>(xyb, planes, h, w, taps, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blur_cols_maps_kernel<<<grid, block, 0, s>>>(xyb, tmp, planes, h, w, taps, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<6><<<planes, kReduceThreads, 0, s>>>(parts, (int)(grid.x * grid.y), sums,
                                                            sums_bstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
