// Host-side helpers of the kernels' launchers, shared by every library
// that checks pointers or sizes a grid by the card's SMs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace host {

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace host
