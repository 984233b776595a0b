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
// What bounds both on this card: device-memory traffic.  Per pixel they read
// one luma sample and 0.5 (4:2:0) to 2 (4:4:4) chroma samples (u8 or u16)
// and write 12 bytes of f32 RGB.  The transfer functions used to take more
// issue slots than those bytes take at the card's memory rate (a runtime
// switch, two IEEE divisions and a full powf per channel: some 355
// instructions per pixel at 10-bit 4:2:2 BT.709); colorspace.cuh now makes
// the transfer function a template parameter, multiplies by reciprocals and
// raises to powers with two MUFU instructions, some 90 instructions per
// pixel (tools/sass_count.py), under the bytes.  What the design does about
// the bytes: one thread per chroma sample reads its (Cb, Cr) pair once for
// the 2x2, 1x2 or 1x1 luma pixels that share it; where a thread's two
// pixels of a row lie inside it and every plane is aligned for them (w even),
// their luma is one load and each channel one float2 store, so a warp
// writes whole 256-byte runs instead of two half-filled stride-2 passes.
// (Those wide accesses measured slower on an H100 while the transfer
// functions bound the kernel; now they take it from 0.132 to 0.094 ms at
// 10-bit 4:2:2 B=8.)  The conversion is the same code as the SSIMULACRA2
// scale-0 pass (colorspace.cuh), so every route sees bit-identical RGB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colorspace.cuh"
#include "level.cuh"

namespace {

// One thread per chroma sample of image blockIdx.z, covering SY x SX luma
// pixels (4:2:0: 2x2, 4:2:2: 1x2, 4:4:4: 1x1), planes of type T, transfer
// function TF.
// grid: (ceil(cw/kBx), ceil(ch/kBy), images)
template <typename T, int SY, int SX, int TF>
__global__ void __launch_bounds__(kThreads)
yuv_to_rgb_kernel(const void* __restrict__ luma_, const void* __restrict__ chroma_, int h, int w,
                  ConvParams p, float* __restrict__ out) {
  const T* __restrict__ luma = static_cast<const T*>(luma_);
  const T* __restrict__ chroma = static_cast<const T*>(chroma_);
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
  // w even and both planes' bases aligned: every pair of a row below is too
  // (a view with an odd offset takes the per-pixel accesses).
  const bool paired = SX == 2 && (w & 1) == 0 && reinterpret_cast<uintptr_t>(luma) % (2 * sizeof(T)) == 0 &&
                      reinterpret_cast<uintptr_t>(out) % sizeof(float2) == 0;
#pragma unroll
  for (int dy = 0; dy < SY; ++dy) {
    if constexpr (SX == 2) {
      const int r = SY * qi + dy;
      const int c = 2 * qj;
      // Both pixels inside the row and aligned in every plane: one load of
      // the two luma samples, one float2 store per channel.
      if (paired && r < h && c + 1 < w) {
        const size_t at = (size_t)r * w + c;
        constexpr int kBits = 8 * sizeof(T);
        const uint32_t both = sizeof(T) == 2 ? __ldg(reinterpret_cast<const unsigned int*>(yp + at))
                                             : __ldg(reinterpret_cast<const unsigned short*>(yp + at));
        float a[3], b[3];
        pixel_rgb<TF>((float)(both & ((1u << kBits) - 1u)), t, p, a);
        pixel_rgb<TF>((float)(both >> kBits), t, p, b);
#pragma unroll
        for (int k = 0; k < 3; ++k) *reinterpret_cast<float2*>(op + k * npx + at) = make_float2(a[k], b[k]);
        continue;
      }
    }
#pragma unroll
    for (int dx = 0; dx < SX; ++dx) {
      const int r = SY * qi + dy;
      const int c = SX * qj + dx;
      if (r < h && c < w) {
        const size_t at = (size_t)r * w + c;
        float rgb[3];
        pixel_rgb<TF>((float)yp[at], t, p, rgb);
        op[at] = rgb[0];
        op[npx + at] = rgb[1];
        op[2 * npx + at] = rgb[2];
      }
    }
  }
}

using ConvKernel = void (*)(const void*, const void*, int, int, ConvParams, float*);

template <typename T, int SY, int SX>
ConvKernel pick_transfer(int transfer) {
  ConvKernel k = nullptr;
  dispatch_transfer(transfer, [&](auto tf) { k = yuv_to_rgb_kernel<T, SY, SX, decltype(tf)::value>; });
  return k;
}

// The instance for u16 (is16) or u8 planes, a subsampling (420, 422, 444) and
// a transfer code; null where one is unknown.
ConvKernel pick(int is16, int subsampling, int transfer) {
  switch (subsampling) {
    case 420:
      return is16 ? pick_transfer<uint16_t, 2, 2>(transfer) : pick_transfer<uint8_t, 2, 2>(transfer);
    case 422:
      return is16 ? pick_transfer<uint16_t, 1, 2>(transfer) : pick_transfer<uint8_t, 1, 2>(transfer);
    case 444:
      return is16 ? pick_transfer<uint16_t, 1, 1>(transfer) : pick_transfer<uint8_t, 1, 1>(transfer);
    default:
      return nullptr;
  }
}

int launch(const void* luma, const void* chroma, int is16, int subsampling, int images, int h, int w,
           const ConvParams& p, int transfer, float* out, cudaStream_t s) {
  const ConvKernel k = pick(is16, subsampling, transfer);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const int ch = subsampling == 420 ? (h + 1) / 2 : h;
  const int cw = subsampling == 444 ? w : (w + 1) / 2;
  const dim3 grid((cw + kBx - 1) / kBx, (ch + kBy - 1) / kBy, images);
  k<<<grid, dim3(kBx, kBy), 0, s>>>(luma, chroma, h, w, p, out);
  return (int)cudaGetLastError();
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
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral};
  return launch(luma, chroma, is16, 420, images, h, w, p, transfer, out,
                static_cast<cudaStream_t>(stream));
}

// The same for any subsampling: chroma (images, ch, cw, 2) with (ch, cw) =
// (ceil(h/2), ceil(w/2)) at 420, (h, ceil(w/2)) at 422, (h, w) at 444.
int tm_yuv_to_rgb(const void* luma, const void* chroma, int is16, int subsampling, int images,
                  int h, int w, float y_coeff, float r_coeff, float b_coeff, float g_coeff1,
                  float g_coeff2, float minimum, float neutral, int transfer, float* out,
                  void* stream) {
  const ConvParams p = {y_coeff, r_coeff, b_coeff, g_coeff1, g_coeff2, minimum, neutral};
  return launch(luma, chroma, is16, subsampling, images, h, w, p, transfer, out,
                static_cast<cudaStream_t>(stream));
}

// What the instance of yuv_to_rgb_kernel for u16 (is16) or u8 planes, a
// subsampling and a transfer code takes on this card: out[0] registers per
// thread, out[1] static shared memory per block in bytes, out[2] resident
// blocks per SM, out[3] local memory per thread in bytes (spills).
int tm_convert_attributes(int is16, int subsampling, int transfer, int* out) {
  const ConvKernel k = pick(is16, subsampling, transfer);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
