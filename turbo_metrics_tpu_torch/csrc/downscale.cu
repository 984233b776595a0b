// The SSIMULACRA2 pyramid step on Hopper (sm_90a): the 2x2 mean of a
// (N, C, h, w) f32 tensor, ceil-sized, the last row/column replicated where
// h or w is odd.
//
// Replaces turbo_metrics_tpu/ops/pallas/convert.py downscale_by_2_pallas
// (l.500, the `pallas2` backend's level step).  The TPU kernel edge-pads in
// jnp, sums row pairs by a reshape and column pairs by an exact 0/1 matmul on
// the MXU; here one thread reads its quad directly, clamping the indices at
// the edge, and sums ((a+b)+c)+d in the order of the plain version
// (ops/downscale.py), so kernel and twin agree bit for bit.
//
// What bounds it on this card: device memory (4 bytes read per input pixel,
// 1 written per input pixel; 4 operations per output pixel).  Neighbouring
// threads read neighbouring pairs of columns, so the loads coalesce into
// 256-byte rows of a warp; nothing more is done about it.

#include <cuda_runtime.h>

#include "level.cuh"

namespace {

// grid: (ceil(wo/kBx), ceil(ho/kBy), N*C), block (kBx, kBy)
__global__ void __launch_bounds__(kThreads)
downscale2_kernel(const float* __restrict__ x, int h, int w, float* __restrict__ out) {
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= ho || j >= wo) return;
  const size_t plane = blockIdx.z;
  const float* src = x + plane * h * w;
  const size_t r0 = (size_t)(2 * i) * w, r1 = (size_t)min(2 * i + 1, h - 1) * w;
  const int c0 = 2 * j, c1 = min(2 * j + 1, w - 1);
  const float s = ((src[r0 + c0] + src[r0 + c1]) + src[r1 + c0]) + src[r1 + c1];
  out[plane * ho * wo + (size_t)i * wo + j] = s * 0.25f;
}

}  // namespace

extern "C" {

// x (planes, h, w) -> out (planes, ceil(h/2), ceil(w/2)); planes = N*C, at
// most 65535.
int tm_downscale2(const float* x, int planes, int h, int w, float* out, void* stream) {
  const dim3 grid = pixel_grid((h + 1) / 2, (w + 1) / 2, planes);
  downscale2_kernel<<<grid, dim3(kBx, kBy), 0, static_cast<cudaStream_t>(stream)>>>(x, h, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
