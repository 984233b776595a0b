// YUV -> clamped linear RGB on Hopper (sm_90a), two entry points over one
// kernel template.  Built and bound like ssimulacra2_scale.cu (plain C entry
// points, caller's stream, return cudaGetLastError()).
//
// tm_yuv420_to_rgb (kernel #6) converts 4:2:0 into a (2, B, 3, h, w) pair
// buffer.  It replaces the JAX package's padded pair conversion
// turbo_metrics_tpu/ops/pallas/convert.py _convert_padded_impl (l.404, behind
// yuv420_to_linear_rgb_padded l.330 and yuv420_pair_to_linear_rgb_padded
// l.367).  The TPU kernel writes into a zero-haloed (8, 128)-tiled layout for
// its consumers' DMA windows; here the buffer is contiguous and unpadded, and
// every consumer masks its own borders.
//
// tm_yuv_to_rgb (kernel #5) converts 4:2:0, 4:2:2 or 4:4:4 planes into
// (images, 3, h, w).  It replaces yuv420_to_linear_rgb_pallas
// (turbo_metrics_tpu/ops/pallas/convert.py:125), which upsamples the chroma
// with 0/1 replication matrices on the MXU; here each thread reads its one
// chroma pair and writes the luma pixels that share it.
//
// What bounds both on this card: f32 instruction issue.  Per pixel they read
// one luma sample and 0.5 (4:2:0) to 2 (4:4:4) chroma samples (u8 or u16)
// and write 12 bytes of f32 RGB, but the three transfer functions in their
// pow form (colorspace.cuh: a powf and two IEEE divisions per channel) take
// more issue slots than the bytes take at the card's memory rate.  What the
// design does about it: one thread per chroma sample reads its (Cb, Cr)
// pair once for the 2x2, 1x2 or 1x1 luma pixels that share it, with few
// registers, so that the SM holds its most warps to hide the latency of the
// transfer functions; the conversion is the same code as the SSIMULACRA2
// scale-0 pass (colorspace.cuh), so every route sees bit-identical RGB.
// Wider per-thread accesses (a float2 store per row and channel; four luma
// columns per thread with float4 stores; four chroma samples per thread
// with 8-byte loads) measured slower on an H100: they cost registers, warps
// and instructions, and the stride-2 stores of a warp already fill the
// sectors they write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "level.cuh"

namespace {

// One thread per chroma sample of image blockIdx.z, covering SY x SX luma
// pixels (4:2:0: 2x2, 4:2:2: 1x2, 4:4:4: 1x1).
// grid: (ceil(cw/kBx), ceil(ch/kBy), images)
template <typename T, int SY, int SX>
__global__ void __launch_bounds__(kThreads)
yuv_to_rgb_kernel(const T* __restrict__ luma, const T* __restrict__ chroma, int h, int w,
                  ConvParams p, float* __restrict__ out) {
  const int ch = (h + SY - 1) / SY, cw = (w + SX - 1) / SX;
  const int qj = blockIdx.x * kBx + threadIdx.x;
  const int qi = blockIdx.y * kBy + threadIdx.y;
  if (qi >= ch || qj >= cw) return;
  const size_t img = blockIdx.z;
  const size_t npx = (size_t)h * w;
  const size_t nq = (size_t)ch * cw;

  const T* cp = chroma + (img * nq + (size_t)qi * cw + qj) * 2;
  const ChromaTerms t = chroma_terms((float)cp[0], (float)cp[1], p);
  const T* yp = luma + img * npx;
  float* op = out + img * 3 * npx;
#pragma unroll
  for (int dy = 0; dy < SY; ++dy) {
#pragma unroll
    for (int dx = 0; dx < SX; ++dx) {
      const int r = SY * qi + dy;
      const int c = SX * qj + dx;
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

template <int SY, int SX>
void launch(const void* luma, const void* chroma, int is16, int images, int h, int w,
            const ConvParams& p, float* out, cudaStream_t s) {
  const int ch = (h + SY - 1) / SY, cw = (w + SX - 1) / SX;
  const dim3 grid((cw + kBx - 1) / kBx, (ch + kBy - 1) / kBy, images);
  const dim3 block(kBx, kBy);
  if (is16) {
    yuv_to_rgb_kernel<uint16_t, SY, SX><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(luma), static_cast<const uint16_t*>(chroma), h, w, p, out);
  } else {
    yuv_to_rgb_kernel<uint8_t, SY, SX><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(luma), static_cast<const uint8_t*>(chroma), h, w, p, out);
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
  launch<2, 2>(luma, chroma, is16, images, h, w, p, out, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The same for any subsampling: chroma (images, ch, cw, 2) with (ch, cw) =
// (ceil(h/2), ceil(w/2)) at 420, (h, ceil(w/2)) at 422, (h, w) at 444.
int tm_yuv_to_rgb(const void* luma, const void* chroma, int is16, int subsampling, int images,
                  int h, int w, float y_coeff, float r_coeff, float b_coeff, float g_coeff1,
                  float g_coeff2, float minimum, float neutral, int transfer, float* out,
                  void* stream) {
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral, transfer};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (subsampling) {
    case 420: launch<2, 2>(luma, chroma, is16, images, h, w, p, out, s); break;
    case 422: launch<1, 2>(luma, chroma, is16, images, h, w, p, out, s); break;
    case 444: launch<1, 1>(luma, chroma, is16, images, h, w, p, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
