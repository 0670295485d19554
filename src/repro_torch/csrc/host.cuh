// Host-side helpers of the kernels' launchers, shared by every library
// that checks pointers or sizes a grid by the card's SMs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace host {

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What a launcher keeps from one launch to the next (the shared-memory
// opt-in above 48 KB, resident blocks a SM, the SM count) belongs to one
// card: cudaFuncSetAttribute and the occupancy and attribute queries act
// on the current device only.  So it is kept in arrays indexed by the
// current device; a device past kMaxDevices keeps nothing and is asked
// again at every launch.
constexpr int kMaxDevices = 64;

inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline bool kept(int dev) { return dev >= 0 && dev < kMaxDevices; }

// The number of SMs of the current device, read once a card.
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = current_device();
  if (kept(dev) && sms[dev] > 0) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 132;
  if (kept(dev)) sms[dev] = n;
  return n;
}

}  // namespace host
