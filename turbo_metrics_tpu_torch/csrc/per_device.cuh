// Host-side setup kept once per CUDA device.
//
// cudaFuncSetAttribute, the occupancy queries and the SM count apply to the
// host thread's current device only.  A setup cached once per process (a
// function-local static) is right for the first device that asked and
// wrong for every other: a launch on a second card would run without the
// dynamic shared memory it was allowed, or with the first card's grid.
// PerDevice keeps one entry per device ordinal instead, made the first time
// that device is current at a call, under a once-flag of its own (launches
// may come from several host threads).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace tm_setup {

constexpr int kMaxDevices = 64;

template <typename T>
struct PerDevice {
  std::once_flag once[kMaxDevices];
  T value[kMaxDevices];

  // The entry of the current device, made by make() (with that device
  // current) at its first use; *err is the cudaGetDevice error, or
  // cudaErrorInvalidDevice past kMaxDevices, with no entry returned.
  template <typename Make>
  const T* get(cudaError_t* err, Make&& make) {
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return nullptr;
    if (dev < 0 || dev >= kMaxDevices) {
      *err = cudaErrorInvalidDevice;
      return nullptr;
    }
    std::call_once(once[dev], [&] { value[dev] = make(dev); });
    return &value[dev];
  }
};

}  // namespace tm_setup
