// The four-step forward NTT of the multi-prime banks in two passes, for
// Hopper (sm_90a): ops.ntt_fourstep_banks on the card.
//
// Replaces no TPU kernel.  In the reference (src/repro/kernels/ops.py
// ntt_fourstep_banks) the four-step is a chain of XLA ops around the
// Pallas kernels: the psi weights (twiddle_mul_banks_pallas), a
// transpose, the column transforms (ntt_fwd_banks_pallas), a
// bit-reversal gather, a transpose back, the step-3 twiddle
// (twiddle_mul_banks_pallas), the row transforms (ntt_fwd_banks_pallas),
// a second gather and the readout transpose.  Run so on the card, that is
// nine passes of the ring through device memory; these two kernels do the
// same arithmetic in two, with the same words out (the lazy [0, 2q) ones
// between the passes included).
//
// What bounds them on an H100: bytes.  Each pass reads and writes each
// word once (8 bytes) and runs log2(n1) / 2 or log2(n2) / 2 butterflies a
// word (8 integer instructions each, lazy), below the bytes' time as in
// the banks (ntt_banks.cu); the weight rows (psi and the step-3 twiddle,
// (k, n) each) are shared by every ring of a prime and come from L2.
//
// What the design does about it.  A ring is an (n1, n2) matrix, x[j1 n2 +
// j2].
//   Column pass (fourstep_cols_kernel): a block takes C adjacent columns
//   j2 of one ring (32 where the grid fills the card, 16 or 8 below, and
//   16 at n1 = 512 for the thread limit); each column's n1-point transform
//   runs on n1 / 16 threads with 16 words each, in ntt_regs.cuh's
//   register schedule (row_phase), crossing shared memory once per 4
//   stages.  Threads of a warp take neighbouring columns, so every load
//   and store is a run of C consecutive words (128 bytes at C = 32).  The
//   psi weight rides on the load; the output k1 = brev(j1) goes straight to
//   its natural row, x'[k1 n2 + j2], times the step-3 twiddle
//   tw[k1 n2 + j2]: no transpose, no gather, no twiddle launch.
//   Row pass (fourstep_rows_kernel): a block takes R consecutive rows k1
//   of one ring (32, or 16 or 8 for a small grid); each row's n2-point
//   transform is ntt_regs.cuh's row body (row_stages).  The transformed
//   rows go to shared memory as an (n2, R) tile and leave as the natural
//   readout A[k2 n1 + k1]: runs of R consecutive k1 for each k2, at least
//   32 bytes each; the epilogue reduces to [0, q).
// Between the passes the ring sits in a scratch tensor the wrapper
// allocates; x and the output may have any strides over (prime, ring), so
// a batch-leading stack needs no copy.  Rings of 2^10 .. 2^17 words, the
// balanced splits n1 = n2 or 2 n2 (32 x 32 .. 512 x 256); negacyclic is a
// flag, lazy a template argument.
#include <cuda_runtime.h>

#include <cstdint>

#include "host.cuh"
#include "modarith.cuh"
#include "ntt_regs.cuh"

namespace {

using ntt_regs::Arith;
using ntt_regs::deposit;
using ntt_regs::group;
using ntt_regs::phases;

constexpr int kRB = 4;            // 16 words a thread
constexpr int kMaxThreads = 512;

// Per-prime tables of one launch (rows of k primes, uint32 values).
struct Plan {
  const uint32_t* qs;
  const uint32_t* psi;    // (k, n) negacyclic pre-weights
  const uint32_t* psip;
  const uint32_t* tw1;    // (k, L1, n1 / 2) column stages
  const uint32_t* twp1;
  const uint32_t* tw;     // (k, n) step-3 twiddle, [k1 n2 + j2]
  const uint32_t* twp;
  const uint32_t* tw2;    // (k, L2, n2 / 2) row stages
  const uint32_t* twp2;
  bool negacyclic;
};

__device__ __forceinline__ uint32_t brev(uint32_t v, int bits) {
  return __brev(v) >> (32 - bits);
}

// Row stride of the row pass's output tile (n2 rows of R words): at least
// R, and W mod 32 for W = 32 / (n2 / 16) rows a warp, so a warp's stores
// of one register (lanes of W rows, at k2 whose low bits are the row
// threads' bit-reversed indices) fall in distinct banks.
__host__ __device__ constexpr int tile_stride(int rows, int l2) {
  return ((rows - (512 >> l2) + 31) & ~31) + (512 >> l2);
}

// The column pass's phases: phase K's stages, then (while phases remain)
// the column through shared memory to the registers of phase K + 1.
// scol: this column's n1 words; its neighbours' lie n1 + 1 words apart, so
// a warp of neighbouring columns hits 32 banks.
template <bool kLazy, int L1, int K>
__device__ __forceinline__ void col_stages(uint32_t (&v)[1 << kRB],
                                           const Arith<uint32_t, kLazy>& ar,
                                           const uint32_t* tw, const uint32_t* twp,
                                           uint32_t i, uint32_t* scol) {
  constexpr int g1 = group(true, K, L1, kRB);
  ntt_regs::row_phase<uint32_t, kLazy, true, L1, L1, kRB, K, false>(
      v, ar, tw, twp, L1, deposit(i, g1, kRB));
  if constexpr (K + 1 < phases(L1, kRB)) {
    constexpr int g2 = group(true, K + 1, L1, kRB);
    __syncthreads();
    const uint32_t s1 = deposit(i, g1, kRB);
#pragma unroll
    for (int r = 0; r < (1 << kRB); ++r) scol[s1 | ((uint32_t)r << g1)] = v[r];
    __syncthreads();
    const uint32_t s2 = deposit(i, g2, kRB);
#pragma unroll
    for (int r = 0; r < (1 << kRB); ++r) v[r] = scol[s2 | ((uint32_t)r << g2)];
    col_stages<kLazy, L1, K + 1>(v, ar, tw, twp, i, scol);
  }
}

// Pass 1: block t takes columns [jt C, jt C + C) of ring (p, ring), the
// rings of a prime and column tile in consecutive blocks (so a prime's
// weight rows are read from L2).  Thread (i, c): column c, row-thread i.
// y: the (k, b, n) scratch.
template <bool kLazy, int L1, int L2>
__global__ void __launch_bounds__(kMaxThreads)
fourstep_cols_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     Plan pl, int b, int logc, long long sxp, long long sxb) {
  constexpr int L = L1 + L2;
  constexpr int R = 1 << kRB;
  constexpr int g0 = group(true, 0, L1, kRB);
  constexpr int gl = group(true, phases(L1, kRB) - 1, L1, kRB);
  extern __shared__ __align__(16) uint32_t smem[];

  const uint32_t c = threadIdx.x & ((1u << logc) - 1u);
  const uint32_t i = threadIdx.x >> logc;
  const long long t = blockIdx.x;
  const long long ring = t % b;
  const long long pt = t / b;               // p * (column tiles) + jt
  const int p = (int)(pt >> (L2 - logc));
  const uint32_t j2 = ((uint32_t)(pt & ((1 << (L2 - logc)) - 1)) << logc) + c;

  const uint32_t q = pl.qs[p];
  const Arith<uint32_t, kLazy> ar{q, q << 1};
  const size_t prow = ((size_t)p << L) + j2;  // this column of a (k, n) table
  const uint32_t b0 = deposit(i, g0, kRB);
  const uint32_t* xc = x + p * sxp + ring * sxb + j2;
  uint32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = xc[(size_t)(b0 | ((uint32_t)r << g0)) << L2];
  if (pl.negacyclic) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t at = prow + ((size_t)(b0 | ((uint32_t)r << g0)) << L2);
      v[r] = ar.mul(v[r], __ldg(pl.psi + at), __ldg(pl.psip + at));
    }
  }
  const size_t th = (size_t)L1 << (L1 - 1);
  col_stages<kLazy, L1, 0>(v, ar, pl.tw1 + p * th, pl.twp1 + p * th, i,
                           smem + c * ((1 << L1) + 1));
  // word o of the column is frequency k1 = brev(o): to row k1, twiddled
  const uint32_t bl = deposit(i, gl, kRB);
  uint32_t* yc = y + (((size_t)p * b + ring) << L) + j2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = (size_t)brev(bl | ((uint32_t)r << gl), L1) << L2;
    yc[at] = ar.mul(v[r], __ldg(pl.tw + prow + at), __ldg(pl.twp + prow + at));
  }
}

// Pass 2: block t takes rows [rt R, rt R + R) of ring (p, ring) of the
// scratch; thread (lr, i): row lr, row-thread i, as ntt_rows_kernel's.
template <bool kLazy, int L1, int L2>
__global__ void __launch_bounds__(kMaxThreads)
fourstep_rows_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                     Plan pl, int b, int logr, long long sop, long long sob) {
  constexpr int L = L1 + L2;
  constexpr int R = 1 << kRB;
  constexpr int TPR = 1 << (L2 - kRB);
  constexpr int g0 = group(true, 0, L2, kRB);
  constexpr int gl = group(true, phases(L2, kRB) - 1, L2, kRB);
  extern __shared__ __align__(16) uint32_t smem[];

  const int lr = threadIdx.x / TPR;
  const uint32_t i = threadIdx.x % TPR;
  const long long t = blockIdx.x;
  const long long pr = t >> (L1 - logr);    // p * b + ring
  const int p = (int)(pr / b);
  const long long ring = pr - (long long)p * b;
  const uint32_t k10 = (uint32_t)(t & ((1 << (L1 - logr)) - 1)) << logr;

  const uint32_t q = pl.qs[p];
  const Arith<uint32_t, kLazy> ar{q, q << 1};
  const uint32_t b0 = deposit(i, g0, kRB);
  const uint32_t* yr = y + ((size_t)pr << L) + ((size_t)(k10 + lr) << L2) + b0;
  uint32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = yr[r << g0];
  const size_t th = (size_t)L2 << (L2 - 1);
  ntt_regs::row_stages<uint32_t, kLazy, true, L2, L2, kRB, false, 0>(
      v, ar, pl.tw2 + p * th, pl.twp2 + p * th, L2, 0u, i,
      smem + lr * ntt_regs::row_stride(L2));
  // word o of the row is frequency k2 = brev(o): the (n2, R) tile, then
  // out[k2 n1 + k1] as runs of R consecutive k1
  const int rows = 1 << logr;
  const int stride = tile_stride(rows, L2);
  const uint32_t bl = deposit(i, gl, kRB);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
    smem[brev(bl | ((uint32_t)r << gl), L2) * stride + lr] = ar.fwd_out(v[r], true);
  __syncthreads();
  uint32_t* o = out + p * sop + ring * sob + k10;
  for (int e = threadIdx.x; e < (rows << L2); e += blockDim.x) {
    const int k2 = e >> logr;
    const int r = e & (rows - 1);
    o[((size_t)k2 << L1) + r] = smem[k2 * stride + r];
  }
}

// Columns (C = 2^logc) and rows (2^logr) a block: 32 each, fewer while
// the grid would leave SMs without a block (down to 8: 32-byte runs), and
// never more than kMaxThreads threads.
template <bool kLazy, int L1, int L2>
int launch(const uint32_t* x, uint32_t* out, uint32_t* scratch, const Plan& pl,
           int k, int b, long long sxp, long long sxb, long long sop, long long sob,
           cudaStream_t s) {
  constexpr int TPC = 1 << (L1 - kRB);     // threads a column
  constexpr int TPR = 1 << (L2 - kRB);     // threads a row
  const long long sms = host::sm_count();
  const long long rings = (long long)k * b;
  int logc = 5;
  while ((TPC << logc) > kMaxThreads) --logc;
  while (logc > 3 && (rings << (L2 - logc)) < sms) --logc;
  int logr = 5;
  while (logr > 3 && (rings << (L1 - logr)) < sms) --logr;
  if ((rings << (L2 - 3)) >= (1LL << 31) || (rings << (L1 - 3)) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;

  const size_t smem1 = sizeof(uint32_t) * ((size_t)1 << logc) * ((1 << L1) + 1);
  fourstep_cols_kernel<kLazy, L1, L2>
      <<<(unsigned)(rings << (L2 - logc)), TPC << logc, smem1, s>>>(x, scratch, pl, b, logc,
                                                                    sxp, sxb);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t exch = (size_t)ntt_regs::row_stride(L2) << logr;
  const size_t tile = (size_t)tile_stride(1 << logr, L2) << L2;
  const size_t smem2 = sizeof(uint32_t) * (exch > tile ? exch : tile);
  fourstep_rows_kernel<kLazy, L1, L2>
      <<<(unsigned)(rings << (L1 - logr)), TPR << logr, smem2, s>>>(scratch, out, pl, b, logr,
                                                                    sop, sob);
  return (int)cudaGetLastError();
}

template <bool kLazy>
int dispatch(int l1, int l2, const uint32_t* x, uint32_t* out, uint32_t* scratch,
             const Plan& pl, int k, int b, long long sxp, long long sxb, long long sop,
             long long sob, cudaStream_t s) {
#define FOURSTEP_SPLIT(A, B)                                                           \
  if (l1 == A && l2 == B)                                                              \
    return launch<kLazy, A, B>(x, out, scratch, pl, k, b, sxp, sxb, sop, sob, s);
  FOURSTEP_SPLIT(5, 5) FOURSTEP_SPLIT(6, 5) FOURSTEP_SPLIT(6, 6) FOURSTEP_SPLIT(7, 6)
  FOURSTEP_SPLIT(7, 7) FOURSTEP_SPLIT(8, 7) FOURSTEP_SPLIT(8, 8) FOURSTEP_SPLIT(9, 8)
#undef FOURSTEP_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (k, b, n1 n2) with element (p, ring, j) at p sxp + ring sxb + j, rows
// reduced mod qs[p]; out likewise with (sop, sob); scratch a contiguous
// (k, b, n1 n2) tensor; the tables in the FourStepPack layout, contiguous,
// k rows each.  Returns cudaGetLastError() of the launches; the wrapper
// (kernels/ntt_kernel.py) checks shapes and raises on a non-zero code.
extern "C" int ntt_fourstep_banks(const void* x, void* out, void* scratch, const void* qs,
                                  const void* psi, const void* psip, const void* tw1,
                                  const void* twp1, const void* tw, const void* twp,
                                  const void* tw2, const void* twp2, int k, int b, int n1,
                                  int n2, long long sxp, long long sxb, long long sop,
                                  long long sob, int negacyclic, int lazy, void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const Plan pl{u(qs), u(psi), u(psip), u(tw1), u(twp1), u(tw), u(twp), u(tw2), u(twp2),
                negacyclic != 0};
  const uint32_t* xi = u(x);
  auto* o = static_cast<uint32_t*>(out);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* s = static_cast<cudaStream_t>(stream);
  const int l1 = ntt_regs::ilog2(n1), l2 = ntt_regs::ilog2(n2);
  if ((1 << l1) != n1 || (1 << l2) != n2) return (int)cudaErrorInvalidValue;
  return lazy ? dispatch<true>(l1, l2, xi, o, sc, pl, k, b, sxp, sxb, sop, sob, s)
              : dispatch<false>(l1, l2, xi, o, sc, pl, k, b, sxp, sxb, sop, sob, s);
}
