// Key-switch digit MAC for Hopper (sm_90a):
//   out[p, b, j] = sum_d ext[d, p, b, j] * evk[d, p, (b,) j]  mod q_p
//
// Replaces the TPU kernel src/repro/kernels/dyadic_kernel.py
// dyadic_inner_banks (_inner_banks_kernel): the paper's Fig 22 MM/MA
// arrays, 32-bit Barrett products accumulated over every digit.
//
// What bounds it on an H100: device memory.  Each output word reads d
// extension words and d key words (the shared key once per prime row,
// reused across the batch through L2) and writes one word; the Barrett
// products are a few integer multiplies per byte read.  The least time
// is those bytes over the card's memory rate.
//
// What this simple design does about it: one thread per output word,
// with the digit loop inside the thread, so the accumulator stays in a
// register across all digits and the output crosses device memory once.
// Consecutive threads read consecutive words of every digit plane, so
// each digit's loads are coalesced.  The key is either shared (d, k, n)
// or per batch row (d, k, B, n).  The lazy/eager accumulate order is the
// reference's exactly: lazy keeps products and the accumulator in
// [0, 2q) and reduces once at the end.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;

template <bool kLazy, bool kPerBatch>
__global__ void __launch_bounds__(kThreads)
dyadic_inner_banks_kernel(const uint32_t* __restrict__ ext,
                          const uint32_t* __restrict__ evk,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ qs,
                          const uint32_t* __restrict__ mus, int d, int k,
                          long long bn, int n, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long p = idx / bn;
    const long long rem = idx - p * bn;
    const long long j = rem % n;
    const uint32_t q = qs[p];
    const uint32_t mu = mus[p];
    const uint32_t q2 = q << 1;
    const long long ext_stride = (long long)k * bn;
    const long long key_stride = kPerBatch ? (long long)k * bn : (long long)k * n;
    const long long key_off = kPerBatch ? p * bn + rem : p * n + j;
    uint32_t acc = kLazy ? barrett_lazy(ext[idx], evk[key_off], q, mu)
                         : barrett(ext[idx], evk[key_off], q, mu);
    for (int dd = 1; dd < d; ++dd) {
      const uint32_t e = ext[dd * ext_stride + idx];
      const uint32_t key = evk[dd * key_stride + key_off];
      if (kLazy) {
        acc = lazy_add(acc, barrett_lazy(e, key, q, mu), q2);
      } else {
        acc = add_mod(acc, barrett(e, key, q, mu), q);
      }
    }
    if (kLazy) acc = acc >= q ? acc - q : acc;
    out[idx] = acc;
  }
}

}  // namespace

// ext (d, k, b, n); evk (d, k, n) or, with per_batch, (d, k, b, n);
// out (k, b, n); qs, mus (k,).  All uint32 (int32 bit patterns),
// contiguous, checked by the Python wrapper.  Returns cudaGetLastError().
extern "C" int dyadic_inner_banks(const void* ext, const void* evk, void* out,
                                  const void* qs, const void* mus, int d, int k,
                                  long long b, int n, int per_batch, int lazy,
                                  void* stream) {
  const long long bn = b * n;
  const long long total = bn * k;
  if (total <= 0 || d <= 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_ext = static_cast<const uint32_t*>(ext);
  const auto* a_evk = static_cast<const uint32_t*>(evk);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_mus = static_cast<const uint32_t*>(mus);
#define LAUNCH(L, P)                                                      \
  dyadic_inner_banks_kernel<L, P><<<grid, kThreads, 0, s>>>(              \
      a_ext, a_evk, a_out, a_qs, a_mus, d, k, bn, n, total)
  if (lazy) {
    if (per_batch) LAUNCH(true, true); else LAUNCH(true, false);
  } else {
    if (per_batch) LAUNCH(false, true); else LAUNCH(false, false);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
