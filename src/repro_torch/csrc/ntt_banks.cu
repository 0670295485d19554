// Multi-prime NTT banks for Hopper (sm_90a): forward and inverse
// constant-geometry transforms and the per-prime weight-row multiply.
//
// Replaces the TPU kernels of src/repro/kernels/ntt_kernel.py:
//   ntt_fwd_banks      <- ntt_fwd_banks_pallas     (_ntt_fwd_banks_kernel)
//   ntt_inv_banks      <- ntt_inv_banks_pallas     (_ntt_inv_banks_kernel)
//   twiddle_mul_banks  <- twiddle_mul_banks_pallas (_twiddle_mul_banks_kernel)
//
// The two transforms are templated on the lane, as the TPU kernels follow
// their element dtype: uint32_t storage with the 32-bit Shoup multiply
// (the CKKS RNS primes; launchers ntt_fwd_banks / ntt_inv_banks), or
// uint16_t storage with the 16-bit one (ML-KEM's q = 3329 ring, whose
// incomplete transform runs 7 stages on n = 256; launchers
// ntt_fwd_banks_u16 / ntt_inv_banks_u16).  Any stage count up to log2 n
// works.
//
// What bounds them on an H100: device memory, with the integer pipes
// close behind.  A transform reads each word once and writes it once (8
// bytes per u32 word); in between it runs log2(n)/2 butterflies per word,
// a lazy u32 one 8 integer instructions as compiled (the Shoup product
// IMAD.HI, IMAD, IMAD; the band add 2; the subtract 3), which at n = 128
// comes to about 0.7 of the bytes' time.  The 16-bit lane moves half the
// bytes for the same butterflies (9 instructions each), so its bound is
// the instructions.  The weight-row multiply reads the word and its two
// weights and writes one word: bytes.
//
// What the transforms' design does about it (ntt_regs.cuh): words stay in
// registers under their original indices, 16 to a thread, and each stage
// whose pairing bit is a register bit runs there; a row crosses shared
// memory once per 4 stages (once at n = 128 and 256), conflict-free, with
// a warp barrier while a row fits a warp, and twiddle columns are a
// per-stage base plus a constant; small rings read their twiddles from a
// copy of the table pair in shared memory.  So a word costs its bytes, its
// butterflies and little else.  A block holds 32 to 256 threads, fewer
// when the batch is small, on a persistent grid of at most one wave; below
// one warp per SM, rings of 16 .. 256 words take 4 words a thread instead
// of 16, a shorter chain per thread for a B = 1 request.  Rings up to 4096
// words take one launch.  Larger u32 rings (2^13 .. 2^17) take
// two: a column pass over the top L - 12 index bits, then the row body on
// contiguous 4096-word chunks, through a scratch tensor the wrapper
// allocates.
//
// The weight-row multiply is a 16-byte stream, one prime per grid row
// (twiddle_mul_banks_kernel): the bytes in flight per SM set its time, so
// it keeps about 2048 threads resident on each SM, each holding one
// column's weight pair and moving one 16-byte load and one 16-byte store
// per row, with no division in its index.
#include <cuda_runtime.h>

#include <cstdint>

#include "host.cuh"
#include "modarith.cuh"
#include "ntt_regs.cuh"

using namespace modarith;

namespace {

constexpr int kStreamThreads = 256;
constexpr long long kMaxStreamBlocks = 132 * 8;  // 2048 threads on each SM

// The weight-row multiply as a memory stream: grid.y is the prime, so q
// and the prime's weight rows are fixed per block; grid.x strides over
// the prime's b*n words.  kVec: one thread per 16-byte vector, four
// independent Shoup products.  n is a power of two and the launcher makes
// the grid stride a multiple of the n/4 vectors of a row, so a thread's
// column v & (n/4 - 1) never changes: it loads its weight pair once and
// streams x through its rows (no division, and the (k, n) weights leave
// L2 once per thread rather than once per row).  Otherwise one thread per
// word and the column i % n (n not a multiple of 4, or an unaligned
// pointer).
template <bool kLazy, bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
twiddle_mul_banks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ w,
                         const uint32_t* __restrict__ wp, long long per_prime,
                         int n) {
  const int p = blockIdx.y;
  const uint32_t q = qs[p];
  x += (size_t)p * per_prime;
  out += (size_t)p * per_prime;
  w += (size_t)p * n;
  wp += (size_t)p * n;
  auto mul = [q](uint32_t a, uint32_t b, uint32_t bp) {
    return kLazy ? shoup_lazy(a, b, bp, q) : shoup(a, b, bp, q);
  };
  if (kVec) {
    const unsigned items = (unsigned)(per_prime >> 2);
    const unsigned stride = gridDim.x * kStreamThreads;
    unsigned i = blockIdx.x * kStreamThreads + threadIdx.x;
    if (i >= items) return;
    const unsigned col = i & ((unsigned)(n >> 2) - 1);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(w) + col);
    const uint4 bp = __ldg(reinterpret_cast<const uint4*>(wp) + col);
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    uint4* out4 = reinterpret_cast<uint4*>(out);
#pragma unroll 4
    for (; i < items; i += stride) {
      const uint4 a = x4[i];
      out4[i] = make_uint4(mul(a.x, b.x, bp.x), mul(a.y, b.y, bp.y),
                           mul(a.z, b.z, bp.z), mul(a.w, b.w, bp.w));
    }
  } else {
    for (long long i = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
         i < per_prime; i += (long long)gridDim.x * kStreamThreads) {
      const long long j = i % n;
      out[i] = mul(x[i], w[j], wp[j]);
    }
  }
}

using host::aligned16;
using host::sm_count;
using ntt_regs::ilog2;
using ntt_regs::Tables;

constexpr long long kWantBlocks = 4 * 132;  // blocks that fill 132 SMs
// below one warp a SM at 16 words a thread, rings of 16 .. 256 words take
// 4 words a thread (four times the threads, a shorter chain each: ML-KEM's
// b = 1 transforms run a fifth to a third faster on an H100, PERF.md)
constexpr long long kSmallThreads = 132 * 32;

// The row body over `rows` rows of 2^LL words per prime: 256 threads a
// block, halved while there would be fewer than kWantBlocks tiles (down to
// one row, and one warp); a persistent grid of at most one wave of blocks.
template <typename T, bool kLazy, bool kFwd, int LL, int GL, int RB>
int launch_rows(const T* x, T* out, const Tables<T>& tb, int k, int rows,
                cudaStream_t s) {
  constexpr int TPR = 1 << (LL - RB);
  const int least = TPR > 32 ? TPR : 32;
  int tpb = ntt_regs::kThreads;
  auto tiles = [&](int t) { return (rows + t / TPR - 1) / (t / TPR); };
  while (tpb > least && (long long)k * tiles(tpb) < kWantBlocks) tpb /= 2;
  const int rpb = tpb / TPR;
  size_t smem = ntt_regs::phases(LL, RB) > 1
                    ? (size_t)rpb * ntt_regs::row_stride(LL) * sizeof(uint32_t)
                    : 0;
  if (ntt_regs::staged_table_bytes<T, LL, GL>() > 0)
    smem += (size_t)2 * tb.stages * (1 << (GL - 1)) * sizeof(T);
  auto kernel = &ntt_regs::ntt_rows_kernel<T, kLazy, kFwd, LL, GL, RB>;
  // resident blocks a SM, read once a card per block size (tpb is
  // 32 << slot) and shared-memory size of this instantiation
  static int cached_per_sm[host::kMaxDevices][4] = {};
  static size_t cached_smem[host::kMaxDevices][4] = {};
  const int slot = ilog2(tpb) - 5;
  const int dev = host::current_device();
  int per_sm = host::kept(dev) && cached_smem[dev][slot] == smem ? cached_per_sm[dev][slot] : 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tpb, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) per_sm = 1;
    if (host::kept(dev)) {
      cached_smem[dev][slot] = smem;
      cached_per_sm[dev][slot] = per_sm;
    }
  }
  const long long total = (long long)k * tiles(tpb);
  const long long wave = (long long)per_sm * sm_count();
  const dim3 grid((unsigned)(total < wave ? total : wave));
  const bool vec_tables = aligned16(tb.tw) && aligned16(tb.twp) &&
                          ((size_t)tb.stages * (1 << (GL - 1)) * sizeof(T)) % 16 == 0;
  kernel<<<grid, tpb, smem, s>>>(x, out, tb, k, rows, tiles(tpb),
                                 aligned16(x) && aligned16(out), vec_tables);
  return (int)cudaGetLastError();
}

// The column body: one thread per column of each of the b rings.
template <bool kLazy, bool kFwd, int GL>
int launch_cols(const uint32_t* x, uint32_t* out, const Tables<uint32_t>& tb,
                int k, int b, cudaStream_t s) {
  constexpr int S = GL - ntt_regs::kRowLog;
  const long long threads = (long long)b << (GL - S);
  const dim3 grid((unsigned)((threads + ntt_regs::kThreads - 1) / ntt_regs::kThreads),
                  (unsigned)k);
  ntt_regs::ntt_cols_kernel<kLazy, kFwd, S, GL><<<grid, ntt_regs::kThreads, 0, s>>>(
      x, out, tb, b);
  return (int)cudaGetLastError();
}

// A ring of 2^GL words: one row launch up to 4096 words; above, the
// column pass and the chunk rows, through scratch (forward: columns
// first; inverse: chunks first).
template <typename T, bool kLazy, bool kFwd, int GL>
int launch_ring(const T* x, T* out, T* scratch, const Tables<T>& tb, int k,
                int b, cudaStream_t s) {
  if constexpr (GL <= ntt_regs::kRowLog) {
    if constexpr (GL >= 4 && GL <= 8) {
      if ((long long)k * b * (1 << (GL - 4)) < kSmallThreads)
        return launch_rows<T, kLazy, kFwd, GL, GL, 2>(x, out, tb, k, b, s);
    }
    return launch_rows<T, kLazy, kFwd, GL, GL, ntt_regs::reg_bits(GL)>(x, out, tb, k, b, s);
  } else if constexpr (sizeof(T) == 4) {
    constexpr int S = GL - ntt_regs::kRowLog;
    constexpr int LL = ntt_regs::kRowLog;
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    int rc;
    if (kFwd) {
      rc = launch_cols<kLazy, true, GL>(x, scratch, tb, k, b, s);
      if (rc != 0) return rc;
      return launch_rows<T, kLazy, true, LL, GL, 4>(scratch, out, tb, k, b << S, s);
    }
    rc = launch_rows<T, kLazy, false, LL, GL, 4>(x, scratch, tb, k, b << S, s);
    if (rc != 0) return rc;
    return launch_cols<kLazy, false, GL>(scratch, out, tb, k, b, s);
  } else {
    return (int)cudaErrorInvalidValue;  // no u16 ring is larger than 4096
  }
}

template <typename T, bool kLazy, bool kFwd>
int dispatch(const T* x, T* out, T* scratch, const Tables<T>& tb, int k, int b,
             int n, cudaStream_t s) {
  switch (ilog2(n)) {
#define NTT_RING(L) \
  case L:           \
    return launch_ring<T, kLazy, kFwd, L>(x, out, scratch, tb, k, b, s);
    NTT_RING(1) NTT_RING(2) NTT_RING(3) NTT_RING(4) NTT_RING(5) NTT_RING(6)
    NTT_RING(7) NTT_RING(8) NTT_RING(9) NTT_RING(10) NTT_RING(11) NTT_RING(12)
    NTT_RING(13) NTT_RING(14) NTT_RING(15) NTT_RING(16) NTT_RING(17)
#undef NTT_RING
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_transform(bool fwd, const void* x, void* out, void* scratch,
                     const Tables<T>& tb, int k, int b, int n, bool lazy,
                     void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  if (n < 2 || n > (1 << 17) || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  T* sc = static_cast<T*>(scratch);
  if (fwd) {
    return lazy ? dispatch<T, true, true>(xi, o, sc, tb, k, b, n, s)
                : dispatch<T, false, true>(xi, o, sc, tb, k, b, n, s);
  }
  return lazy ? dispatch<T, true, false>(xi, o, sc, tb, k, b, n, s)
              : dispatch<T, false, false>(xi, o, sc, tb, k, b, n, s);
}

template <typename T>
int launch_fwd(const void* x, void* out, const void* qs, const void* tw,
               const void* twp, const void* psi, const void* psip, int k,
               int b, int n, int stages, int negacyclic, int lazy,
               int reduce_out, void* scratch, void* stream) {
  const Tables<T> tb{static_cast<const T*>(qs), static_cast<const T*>(tw),
                     static_cast<const T*>(twp), static_cast<const T*>(psi),
                     static_cast<const T*>(psip), nullptr, nullptr, stages,
                     negacyclic != 0, reduce_out != 0};
  return launch_transform<T>(true, x, out, scratch, tb, k, b, n, lazy != 0, stream);
}

template <typename T>
int launch_inv(const void* x, void* out, const void* qs, const void* ninv,
               const void* ninv_p, const void* itw, const void* itwp,
               const void* post, const void* postp, int k, int b, int n,
               int stages, int negacyclic, int lazy, int reduce_out,
               void* scratch, void* stream) {
  const Tables<T> tb{static_cast<const T*>(qs), static_cast<const T*>(itw),
                     static_cast<const T*>(itwp), static_cast<const T*>(post),
                     static_cast<const T*>(postp), static_cast<const T*>(ninv),
                     static_cast<const T*>(ninv_p), stages, negacyclic != 0,
                     reduce_out != 0};
  return launch_transform<T>(false, x, out, scratch, tb, k, b, n, lazy != 0, stream);
}

}  // namespace

// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises on a non-zero code.  Shapes are checked by the wrapper:
// x/out (k, b, n) with n a power of two in [2, 131072] (the u16 lane up to
// 4096), tables as in the TablePack layout, contiguous; uint32 (int32 bit
// patterns) for the plain launchers, uint16 (int16 bit patterns) for the
// _u16 ones.  scratch: a (k, b, n) tensor of x's lane for n > 4096 (the
// two-pass route), else unused (may be null).  A transform is one
// launcher call whichever route it takes.  twiddle_mul_banks takes x/out
// (k, b, n) and w/wp (k, n).

extern "C" int ntt_fwd_banks(const void* x, void* out, const void* qs,
                             const void* tw, const void* twp, const void* psi,
                             const void* psip, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* scratch, void* stream) {
  return launch_fwd<uint32_t>(x, out, qs, tw, twp, psi, psip, k, b, n, stages,
                              negacyclic, lazy, reduce_out, scratch, stream);
}

extern "C" int ntt_fwd_banks_u16(const void* x, void* out, const void* qs,
                                 const void* tw, const void* twp,
                                 const void* psi, const void* psip, int k,
                                 int b, int n, int stages, int negacyclic,
                                 int lazy, int reduce_out, void* scratch, void* stream) {
  return launch_fwd<uint16_t>(x, out, qs, tw, twp, psi, psip, k, b, n, stages,
                              negacyclic, lazy, reduce_out, scratch, stream);
}

extern "C" int ntt_inv_banks(const void* x, void* out, const void* qs,
                             const void* ninv, const void* ninv_p,
                             const void* itw, const void* itwp, const void* post,
                             const void* postp, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* scratch, void* stream) {
  return launch_inv<uint32_t>(x, out, qs, ninv, ninv_p, itw, itwp, post, postp,
                              k, b, n, stages, negacyclic, lazy, reduce_out,
                              scratch, stream);
}

extern "C" int ntt_inv_banks_u16(const void* x, void* out, const void* qs,
                                 const void* ninv, const void* ninv_p,
                                 const void* itw, const void* itwp,
                                 const void* post, const void* postp, int k,
                                 int b, int n, int stages, int negacyclic,
                                 int lazy, int reduce_out, void* scratch, void* stream) {
  return launch_inv<uint16_t>(x, out, qs, ninv, ninv_p, itw, itwp, post, postp,
                              k, b, n, stages, negacyclic, lazy, reduce_out,
                              scratch, stream);
}

extern "C" int twiddle_mul_banks(const void* x, void* out, const void* qs,
                                 const void* w, const void* wp, int k,
                                 long long b, int n, int lazy, void* stream) {
  const long long per_prime = b * n;
  if (k <= 0 || per_prime <= 0) return (int)cudaGetLastError();
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // the vector path's 32-bit index covers a prime's b*n/4 vectors
  const bool vec = n % 4 == 0 && (n & (n - 1)) == 0 && per_prime / 4 < (1LL << 31) &&
                   aligned(x) && aligned(out) && aligned(w) && aligned(wp);
  const long long items = vec ? per_prime / 4 : per_prime;
  // about 2048 resident threads on each SM over all k primes, then stride;
  // on the vector path the stride is a whole number of rows (n/4 vectors)
  const long long want = (items + kStreamThreads - 1) / kStreamThreads;
  long long blocks = (kMaxStreamBlocks + k - 1) / k;
  if (want <= blocks) {
    blocks = want;  // one step a thread
  } else if (vec) {
    const long long row_blocks = n / 4 > kStreamThreads ? n / 4 / kStreamThreads : 1;
    blocks = blocks > row_blocks ? blocks / row_blocks * row_blocks : row_blocks;
  }
  const dim3 grid((unsigned)blocks, (unsigned)k);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_w = static_cast<const uint32_t*>(w);
  const auto* a_wp = static_cast<const uint32_t*>(wp);
  auto kernel = lazy ? (vec ? &twiddle_mul_banks_kernel<true, true>
                            : &twiddle_mul_banks_kernel<true, false>)
                     : (vec ? &twiddle_mul_banks_kernel<false, true>
                            : &twiddle_mul_banks_kernel<false, false>);
  kernel<<<grid, kStreamThreads, 0, s>>>(a_x, a_out, a_qs, a_w, a_wp, per_prime, n);
  return (int)cudaGetLastError();
}
