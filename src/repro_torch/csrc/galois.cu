// NTT-domain Galois automorphism gathers for Hopper (sm_90a):
//   out[row, j] = x[row, idx[j]]
//
// Replaces the three TPU kernels of src/repro/kernels/galois_kernel.py:
//   galois_banks        <- galois_banks_pallas        one (n,) idx row shared
//                                                     by every (prime, batch) row
//   galois_banks_multi  <- galois_banks_multi_pallas  one idx row per batch
//                                                     element, (B, n)
//   galois_digits       <- galois_digits_pallas       the per-batch gather on
//                                                     every digit of (d, k, B, n);
//                                                     with ``shared`` one
//                                                     (d, k, 1, n) stack fanned
//                                                     out to B gather rows
// In the evaluation domain the automorphism is a pure slot permutation,
// the same for every prime and digit, so all three are one gather body
// with different row-to-index-row maps.
//
// What bounds it on an H100: device memory.  Each output word is one
// index read and one word written; each source row is read once (in the
// shared mode once for all B gathered rows).  No arithmetic.
//
// What this simple design does about it: one block per source row.  The
// block stages its n-word row in dynamic shared memory with coalesced
// 16-byte loads, then writes out[j] = s[idx[j]] with coalesced 16-byte
// index reads and output writes; the random access stays inside shared
// memory.  Rows therefore move only as uint4/int4: n must be a multiple
// of 4 and every pointer 16-byte aligned, else the launch is refused.  In the shared (hoisted) mode the block stages its (digit,
// prime) row once and writes all B gathered rows from it, so the shared
// decomposition is never replicated B-fold in device memory.  An index
// outside [0, n) is a caller error; the kernel writes 0xFFFFFFFF there
// (never a residue) instead of reading outside its row.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
// the most dynamic shared memory one block may take on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;

enum Mode { kSharedIdx = 0, kPerRowIdx = 1, kFanOut = 2 };

__device__ __forceinline__ uint32_t pick(const uint32_t* s, int32_t i, int n) {
  return (unsigned)i < (unsigned)n ? s[i] : 0xFFFFFFFFu;
}

__device__ __forceinline__ void gather_row(const uint32_t* s,
                                           const int32_t* __restrict__ idx,
                                           uint32_t* __restrict__ dst, int n) {
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int j = threadIdx.x; j < n / 4; j += blockDim.x) {
    const int4 i = idx4[j];
    dst4[j] = make_uint4(pick(s, i.x, n), pick(s, i.y, n), pick(s, i.z, n),
                         pick(s, i.w, n));
  }
}

// grid.x = number of source rows.  Source row r is x[r*n .. r*n + n).
//   kSharedIdx: out row r, idx row 0
//   kPerRowIdx: out row r, idx row (r % batch)
//   kFanOut:    out rows r*batch + b for every b < batch, idx row b
template <int kMode>
__global__ void __launch_bounds__(kThreads)
galois_gather_kernel(const uint32_t* __restrict__ x,
                     const int32_t* __restrict__ idx,
                     uint32_t* __restrict__ out, int n, int batch) {
  extern __shared__ uint4 smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const long long r = blockIdx.x;
  const uint4* src4 = reinterpret_cast<const uint4*>(x + r * n);
  for (int j = threadIdx.x; j < n / 4; j += blockDim.x) smem[j] = src4[j];
  __syncthreads();
  if (kMode == kFanOut) {
    for (int b = 0; b < batch; ++b)
      gather_row(s, idx + (long long)b * n, out + (r * batch + b) * n, n);
  } else {
    const long long irow = kMode == kPerRowIdx ? r % batch : 0;
    gather_row(s, idx + irow * n, out + r * n, n);
  }
}

template <int kMode>
int launch(const void* x, const void* idx, void* out, long long rows, int n,
           int batch, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n % 4 != 0 || !aligned(x) || !aligned(idx) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const int smem = n * (int)sizeof(uint32_t);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be asked for
    const cudaError_t e = cudaFuncSetAttribute(
        galois_gather_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  galois_gather_kernel<kMode><<<(unsigned)rows, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrappers: every tensor contiguous,
// words uint32 (int32 bit patterns), idx int32, n a multiple of 4 with
// n * 4 bytes within one block's shared memory, every pointer 16-byte
// aligned.  Every launcher returns cudaGetLastError() of
// its launch (or the error of configuring the kernel); the wrapper raises
// on a non-zero code.

// x, out (k, b, n); idx (n,)
extern "C" int galois_banks(const void* x, const void* idx, void* out, int k,
                            int b, int n, void* stream) {
  return launch<kSharedIdx>(x, idx, out, (long long)k * b, n, 1, stream);
}

// x, out (k, b, n); idx (b, n)
extern "C" int galois_banks_multi(const void* x, const void* idx, void* out,
                                  int k, int b, int n, void* stream) {
  return launch<kPerRowIdx>(x, idx, out, (long long)k * b, n, b, stream);
}

// idx (b, n); out (d, k, b, n); x (d, k, b, n), or (d, k, 1, n) with shared
extern "C" int galois_digits(const void* x, const void* idx, void* out, int d,
                             int k, int b, int n, int shared, void* stream) {
  if (shared) return launch<kFanOut>(x, idx, out, (long long)d * k, n, b, stream);
  return launch<kPerRowIdx>(x, idx, out, (long long)d * k * b, n, b, stream);
}
