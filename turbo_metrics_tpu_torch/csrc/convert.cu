// YUV 4:2:0 -> clamped linear RGB into a (2, B, 3, h, w) pair buffer, on
// Hopper (sm_90a).  Built and bound like ssimulacra2_scale.cu (plain C entry
// point, caller's stream, returns cudaGetLastError()).
//
// Replaces the JAX package's padded pair conversion
// turbo_metrics_tpu/ops/pallas/convert.py _convert_padded_impl (l.404, behind
// yuv420_to_linear_rgb_padded l.330 and yuv420_pair_to_linear_rgb_padded
// l.367).  The TPU kernel writes into a zero-haloed (8, 128)-tiled layout for
// its consumers' DMA windows; here the buffer is contiguous and unpadded, and
// every consumer masks its own borders.
//
// What bounds it on this card: device-memory traffic.  Per pixel it reads 1.5
// samples (u8 or u16) and writes 12 bytes of f32 RGB; the arithmetic (three
// transfer functions) is a few dozen operations.  What the design does about
// it: one thread per 2x2 luma quad reads its (Cb, Cr) pair once, and the
// conversion is the same code as the SSIMULACRA2 scale-0 pass
// (colorspace.cuh), so both routes see bit-identical RGB.  The writes are
// stride-2 within a row; wider per-thread stores are for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "level.cuh"

namespace {

// One thread per 2x2 luma quad of image blockIdx.z.
// grid: (ceil(wq/kBx), ceil(hq/kBy), images)
template <typename T>
__global__ void __launch_bounds__(kThreads)
yuv420_to_rgb_kernel(const T* __restrict__ luma, const T* __restrict__ chroma, int h, int w,
                     ConvParams p, float* __restrict__ out) {
  const int hq = (h + 1) / 2, wq = (w + 1) / 2;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= hq || qj >= wq) return;
  const size_t img = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)hq * wq;

  const T* cp = chroma + (img * nq + (size_t)qi * wq + qj) * 2;
  const ChromaTerms t = chroma_terms((float)cp[0], (float)cp[1], p);
  const T* yp = luma + img * npx;
  float* op = out + img * 3 * npx;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int r = 2 * qi + dy;
      const int c = 2 * qj + dx;
      if (r < h && c < w) {
        const size_t at = (size_t)r * w + c;
        float rgb[3];
        pixel_rgb((float)yp[at], t, p, rgb);
        op[at] = rgb[0];
        op[npx + at] = rgb[1];
        op[2 * npx + at] = rgb[2];
      }
    }
  }
}

}  // namespace

extern "C" {

// images consecutive images: luma (images, h, w), chroma (images,
// ceil(h/2), ceil(w/2), 2), u16 when is16 else u8 -> out (images, 3, h, w)
// f32.  A shared-spec pair is one call with images = 2B; a pair whose two
// inputs differ is one call per image, out pointing at its slot.
int tm_yuv420_to_rgb(const void* luma, const void* chroma, int is16, int images, int h, int w,
                     float y_coeff, float r_coeff, float b_coeff, float g_coeff1, float g_coeff2,
                     float minimum, float neutral, int transfer, float* out, void* stream) {
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral, transfer};
  const dim3 grid = quad_grid(h, w, images);
  const dim3 block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is16) {
    yuv420_to_rgb_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(luma), static_cast<const uint16_t*>(chroma), h, w, p, out);
  } else {
    yuv420_to_rgb_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(luma), static_cast<const uint8_t*>(chroma), h, w, p, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
