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
// the same for every prime and digit, so all three are one gather with
// different row-to-index-row maps (Rows<kMode> below).
//
// What bounds it on an H100: device memory.  Each output word is one
// index read and one word written; each source row is read once (in the
// shared mode once for all B gathered rows).  No arithmetic.
//
// Two bodies, both moving rows only as 16-byte vectors (n must be a
// multiple of 4 and every pointer 16-byte aligned, else the launch is
// refused).  An index outside [0, n) is a caller error; both write
// 0xFFFFFFFF there (never a residue) instead of reading outside the row.
//
// - Split rows (galois_split_kernel): the grid covers (16-byte output
//   vectors of a row) x (output rows).  A thread reads one int4 of idx,
//   gathers its four words straight from the source row in device memory
//   through the read-only path (a rotate's 8 rows of 64 KB stay in the
//   50 MB L2 after the first touch) and writes one uint4.  No shared
//   memory, no barrier, no row-length limit, and a small call spreads
//   over every SM (a rotate's (8, 1, 2^14): 256 blocks).  galois_banks
//   runs it at every n; the other two modes above kMaxSmemRow words.
// - Staged rows (galois_staged_kernel): one block per source row stages
//   the row in dynamic shared memory with coalesced 16-byte loads and
//   gathers from there.  In the fan-out mode the block writes all B
//   gathered rows from one staged row, so the shared decomposition is read
//   from device memory once.  It needs n * 4 bytes of shared memory, so
//   the per-row and fan-out modes take it up to kMaxSmemRow words.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStagedThreads = 512;
constexpr int kSplitThreads = 128;
// the most dynamic shared memory one block may take on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxSmemRow = kMaxSmemBytes / 4;
constexpr unsigned kMaxGridY = 65535;

enum Mode { kSharedIdx = 0, kPerRowIdx = 1, kFanOut = 2 };

// Output row r of a launch reads source row src(r) through idx row
// irow(r).  `batch` is the number of idx rows (B).
//   kSharedIdx: src r,          idx row 0
//   kPerRowIdx: src r,          idx row r % B
//   kFanOut:    src r / B,      idx row r % B   (out rows s*B + b)
// Row counts stay below 2^31 (the wrappers refuse more), so the map takes
// 32-bit division; offsets are taken in 64 bits.
template <int kMode>
struct Rows {
  __device__ __forceinline__ static size_t src(unsigned r, unsigned batch) {
    return kMode == kFanOut ? r / batch : r;
  }
  __device__ __forceinline__ static size_t irow(unsigned r, unsigned batch) {
    return kMode == kSharedIdx ? 0 : r % batch;
  }
};

__device__ __forceinline__ uint32_t pick(const uint32_t* s, int32_t i, int n) {
  return (unsigned)i < (unsigned)n ? s[i] : 0xFFFFFFFFu;
}

__device__ __forceinline__ uint32_t pick_ldg(const uint32_t* __restrict__ s,
                                             int32_t i, int n) {
  return (unsigned)i < (unsigned)n ? __ldg(s + i) : 0xFFFFFFFFu;
}

// grid.x covers the n/4 vectors of a row, grid.y strides over out_rows.
template <int kMode>
__global__ void __launch_bounds__(kSplitThreads)
galois_split_kernel(const uint32_t* __restrict__ x,
                    const int32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, int n, unsigned batch,
                    unsigned out_rows) {
  const int nv = n >> 2;
  const int v = blockIdx.x * kSplitThreads + threadIdx.x;
  if (v >= nv) return;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (unsigned r = blockIdx.y; r < out_rows; r += gridDim.y) {
    const int4 i = __ldg(idx4 + Rows<kMode>::irow(r, batch) * nv + v);
    const uint32_t* s = x + Rows<kMode>::src(r, batch) * n;
    out4[(size_t)r * nv + v] = make_uint4(pick_ldg(s, i.x, n), pick_ldg(s, i.y, n),
                                  pick_ldg(s, i.z, n), pick_ldg(s, i.w, n));
  }
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

// grid.x = number of source rows (Rows<kMode>::src inverted: fan-out
// source row r writes out rows r*B .. r*B + B - 1).
template <int kMode>
__global__ void __launch_bounds__(kStagedThreads)
galois_staged_kernel(const uint32_t* __restrict__ x,
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
    gather_row(s, idx + Rows<kMode>::irow((unsigned)r, batch) * n, out + r * n, n);
  }
}

template <int kMode>
int launch_split(const uint32_t* x, const int32_t* idx, uint32_t* out,
                 long long out_rows, int n, int batch, cudaStream_t stream) {
  const unsigned gx = (unsigned)((n / 4 + kSplitThreads - 1) / kSplitThreads);
  const unsigned gy = (unsigned)(out_rows < kMaxGridY ? out_rows : kMaxGridY);
  galois_split_kernel<kMode><<<dim3(gx, gy), kSplitThreads, 0, stream>>>(
      x, idx, out, n, (unsigned)batch, (unsigned)out_rows);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_staged(const uint32_t* x, const int32_t* idx, uint32_t* out,
                  long long src_rows, int n, int batch, cudaStream_t stream) {
  const int smem = n * (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be asked for
    const cudaError_t e = cudaFuncSetAttribute(
        galois_staged_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  galois_staged_kernel<kMode><<<(unsigned)src_rows, kStagedThreads, smem, stream>>>(
      x, idx, out, n, batch);
  return (int)cudaGetLastError();
}

// src_rows source rows of n words; the mode's map gives the output rows
// (src_rows * batch in the fan-out mode, src_rows otherwise).
template <int kMode>
int launch(const void* x, const void* idx, void* out, long long src_rows, int n,
           int batch, void* stream) {
  if (src_rows <= 0 || n <= 0) return (int)cudaGetLastError();
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n % 4 != 0 || !aligned(x) || !aligned(idx) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* pi = static_cast<const int32_t*>(idx);
  auto* po = static_cast<uint32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if constexpr (kMode != kSharedIdx) {
    if (n <= kMaxSmemRow) return launch_staged<kMode>(px, pi, po, src_rows, n, batch, s);
  }
  const long long out_rows = kMode == kFanOut ? src_rows * batch : src_rows;
  return launch_split<kMode>(px, pi, po, out_rows, n, batch, s);
}

}  // namespace

// Shapes are checked by the Python wrappers: every tensor contiguous,
// words uint32 (int32 bit patterns), idx int32, n a multiple of 4, every
// pointer 16-byte aligned.  Every launcher returns cudaGetLastError() of
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
