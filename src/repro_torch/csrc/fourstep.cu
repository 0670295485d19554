// The four-step NTT of the multi-prime banks in two passes each way, for
// Hopper (sm_90a): ops.ntt_fourstep_banks and ops.intt_fourstep_banks on
// the card.
//
// Replaces no TPU kernel.  In the reference (src/repro/kernels/ops.py
// ntt_fourstep_banks) the four-step is a chain of XLA ops around the
// Pallas kernels: the psi weights (twiddle_mul_banks_pallas), a
// transpose, the column transforms (ntt_fwd_banks_pallas), a
// bit-reversal gather, a transpose back, the step-3 twiddle
// (twiddle_mul_banks_pallas), the row transforms (ntt_fwd_banks_pallas),
// a second gather and the readout transpose; its intt_fourstep_banks
// runs the same chain backwards (the readout's transpose, a gather, the
// row inverses, the inverse twiddle, a transpose and a gather, the column
// inverses, the transpose back, the psi^-1 weights).  Run so on the card,
// each is nine passes of the ring through device memory; these kernels do
// the same arithmetic in two, with the same words out (the lazy [0, 2q)
// ones between the passes included).
//
// What bounds them on an H100: bytes.  Each pass reads and writes each
// word once (8 bytes) and runs log2(n1) / 2 or log2(n2) / 2 butterflies a
// word (8 integer instructions each, lazy), below the bytes' time as in
// the banks (ntt_banks.cu); the weight rows (psi or psi^-1 and the step-3
// twiddle, (k, n) each) are shared by every ring of a prime and come from
// L2.
//
// What the design does about it.  A ring is an (n1, n2) matrix, x[j1 n2 +
// j2]; its transform A[k2 n1 + k1] an (n2, n1) one.
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
//   The inverse mirrors them.  Its row pass (fourstep_irows_kernel) reads
//   the natural A as runs of R consecutive k1 for each k2 into the (n2, R)
//   tile, and each row thread takes its words at bit-reversed k2 from it
//   (the inverse body's input order); the row inverse, its n2^-1 epilogue
//   and the inverse step-3 twiddle itw[k1 n2 + j2] run before the row
//   leaves for the scratch (runs of n2 / 16 words: 64 bytes at n2 = 256).
//   Each thread starts all its tile loads before its first store, so R
//   loads a thread are in flight while the tile fills.  Its column
//   pass (fourstep_icols_kernel) reads each column's k1 at bit-reversed
//   positions as runs of C words, with its outputs' psi^-i words (loaded
//   before the stages, whose work hides their latency), runs the n1-point
//   inverse, and stores x[j1 n2 + j2] as runs of C words after the n1^-1
//   epilogue and (negacyclic) the psi^-i weight, in [0, q).
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

// Per-prime tables of one launch (rows of k primes, uint32 values); the
// forward reads its stage tables, psi and tw, the inverse its inverse
// stage tables, psi^-i, itw and the two n^-1 scalars.
struct Plan {
  const uint32_t* qs;
  const uint32_t* psi;    // (k, n) negacyclic pre-weights, or psi^-i post-weights
  const uint32_t* psip;
  const uint32_t* tw1;    // (k, L1, n1 / 2) column stages
  const uint32_t* twp1;
  const uint32_t* tw;     // (k, n) step-3 twiddle or its inverse, [k1 n2 + j2]
  const uint32_t* twp;
  const uint32_t* tw2;    // (k, L2, n2 / 2) row stages
  const uint32_t* twp2;
  const uint32_t* ninv1;  // (k,) n1^-1 (the inverse's column epilogue)
  const uint32_t* ninv1p;
  const uint32_t* ninv2;  // (k,) n2^-1 (the inverse's row epilogue)
  const uint32_t* ninv2p;
  bool negacyclic;
};

// One launch's operands: x and out with their (prime, ring) strides, the
// contiguous (k, b, n) scratch between the passes.
struct Args {
  const uint32_t* x;
  uint32_t* out;
  uint32_t* scratch;
  Plan pl;
  int k, b;
  long long sxp, sxb, sop, sob;
  cudaStream_t s;
};

__device__ __forceinline__ uint32_t brev(uint32_t v, int bits) {
  return __brev(v) >> (32 - bits);
}

// Row stride of the row passes' (n2, R) tile: at least R, and W mod 32
// for W = 32 / (n2 / 16) rows a warp, so a warp's accesses of one register
// (lanes of W rows, at k2 whose low bits are the row threads' bit-reversed
// indices) fall in distinct banks.
__host__ __device__ constexpr int tile_stride(int rows, int l2) {
  return ((rows - (512 >> l2) + 31) & ~31) + (512 >> l2);
}

// The column passes' phases: phase K's stages, then (while phases remain)
// the column through shared memory to the registers of phase K + 1.
// scol: this column's n1 words; its neighbours' lie n1 + 1 words apart, so
// a warp of neighbouring columns hits 32 banks.
template <bool kLazy, bool kFwd, int L1, int K>
__device__ __forceinline__ void col_stages(uint32_t (&v)[1 << kRB],
                                           const Arith<uint32_t, kLazy>& ar,
                                           const uint32_t* tw, const uint32_t* twp,
                                           uint32_t i, uint32_t* scol) {
  constexpr int g1 = group(kFwd, K, L1, kRB);
  ntt_regs::row_phase<uint32_t, kLazy, kFwd, L1, L1, kRB, K, false>(
      v, ar, tw, twp, L1, deposit(i, g1, kRB));
  if constexpr (K + 1 < phases(L1, kRB)) {
    constexpr int g2 = group(kFwd, K + 1, L1, kRB);
    __syncthreads();
    const uint32_t s1 = deposit(i, g1, kRB);
#pragma unroll
    for (int r = 0; r < (1 << kRB); ++r) scol[s1 | ((uint32_t)r << g1)] = v[r];
    __syncthreads();
    const uint32_t s2 = deposit(i, g2, kRB);
#pragma unroll
    for (int r = 0; r < (1 << kRB); ++r) v[r] = scol[s2 | ((uint32_t)r << g2)];
    col_stages<kLazy, kFwd, L1, K + 1>(v, ar, tw, twp, i, scol);
  }
}

// Forward pass 1: block t takes columns [jt C, jt C + C) of ring (p,
// ring), the rings of a prime and column tile in consecutive blocks (so a
// prime's weight rows are read from L2).  Thread (i, c): column c,
// row-thread i.  y: the (k, b, n) scratch.
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
  col_stages<kLazy, true, L1, 0>(v, ar, pl.tw1 + p * th, pl.twp1 + p * th, i,
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

// Forward pass 2: block t takes rows [rt R, rt R + R) of ring (p, ring) of
// the scratch; thread (lr, i): row lr, row-thread i, as ntt_rows_kernel's.
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

// Inverse pass 1: block t takes rows [rt R, rt R + R) (frequencies k1) of
// ring (p, ring) of x, A[k2 n1 + k1]: runs of R consecutive k1 for each k2
// into the (n2, R) tile; thread (lr, i) then takes row lr as row-thread i,
// word o at k2 = brev(o), as ntt_rows_kernel's inverse.  y: the scratch.
template <bool kLazy, int L1, int L2>
__global__ void __launch_bounds__(kMaxThreads)
fourstep_irows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                      Plan pl, int b, int logr, long long sxp, long long sxb) {
  constexpr int L = L1 + L2;
  constexpr int R = 1 << kRB;
  constexpr int TPR = 1 << (L2 - kRB);
  constexpr int g0 = group(false, 0, L2, kRB);
  constexpr int gl = group(false, phases(L2, kRB) - 1, L2, kRB);
  extern __shared__ __align__(16) uint32_t smem[];

  const int lr = threadIdx.x / TPR;
  const uint32_t i = threadIdx.x % TPR;
  const long long t = blockIdx.x;
  const long long pr = t >> (L1 - logr);    // p * b + ring
  const int p = (int)(pr / b);
  const long long ring = pr - (long long)p * b;
  const uint32_t k10 = (uint32_t)(t & ((1 << (L1 - logr)) - 1)) << logr;
  const int rows = 1 << logr;
  const int stride = tile_stride(rows, L2);

  // the tile: R words a thread (blockDim.x = R rows n2 / 16), all loads
  // in flight before the first store
  const uint32_t* xr = x + p * sxp + ring * sxb + k10;
  uint32_t v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    v[j] = xr[((size_t)(e >> logr) << L1) + (e & (rows - 1))];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    smem[(e >> logr) * stride + (e & (rows - 1))] = v[j];
  }
  __syncthreads();
  const uint32_t b0 = deposit(i, g0, kRB);
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = smem[brev(b0 | ((uint32_t)r << g0), L2) * stride + lr];
  __syncthreads();                          // the tile's words are read: exchanges may reuse it

  const uint32_t q = pl.qs[p];
  const Arith<uint32_t, kLazy> ar{q, q << 1};
  const size_t th = (size_t)L2 << (L2 - 1);
  ntt_regs::row_stages<uint32_t, kLazy, false, L2, L2, kRB, false, 0>(
      v, ar, pl.tw2 + p * th, pl.twp2 + p * th, L2, 0u, i,
      smem + lr * ntt_regs::row_stride(L2));
  const uint32_t bl = deposit(i, gl, kRB);
  const uint32_t wn = pl.ninv2[p], wnp = pl.ninv2p[p];
  // word o of the row is j2 = o: n2^-1 (the lazy epilogue), the inverse
  // step-3 twiddle itw[k1 n2 + j2], to row k1 of the scratch
  const size_t at = ((size_t)(k10 + lr) << L2) + bl;
  const size_t trow = ((size_t)p << L) + at;  // in the (k, n) twiddle
  uint32_t* yr = y + ((size_t)pr << L) + at;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t o = (size_t)r << gl;
    yr[o] = ar.mul(ar.inv_out(v[r], wn, wnp, false), __ldg(pl.tw + trow + o),
                   __ldg(pl.twp + trow + o));
  }
}

// Inverse pass 2: block t takes columns [jt C, jt C + C) of ring (p, ring)
// of the scratch, as fourstep_cols_kernel; word o of column j2 is row
// k1 = brev(o).  The output x[j1 n2 + j2] in [0, q).
template <bool kLazy, int L1, int L2>
__global__ void __launch_bounds__(kMaxThreads)
fourstep_icols_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                      Plan pl, int b, int logc, long long sop, long long sob) {
  constexpr int L = L1 + L2;
  constexpr int R = 1 << kRB;
  constexpr int g0 = group(false, 0, L1, kRB);
  constexpr int gl = group(false, phases(L1, kRB) - 1, L1, kRB);
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
  const uint32_t b0 = deposit(i, g0, kRB);
  const uint32_t* yc = y + (((size_t)p * b + ring) << L) + j2;
  uint32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = yc[(size_t)brev(b0 | ((uint32_t)r << g0), L1) << L2];
  const uint32_t bl = deposit(i, gl, kRB);
  const size_t prow = ((size_t)p << L) + j2;  // this column of the (k, n) psi^-i
  // the psi^-i words of the thread's outputs, loaded beside the column's
  // (their latency hides behind the stages)
  uint32_t pw[R], pwp[R];
  if (pl.negacyclic) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t at = (size_t)(bl | ((uint32_t)r << gl)) << L2;
      pw[r] = __ldg(pl.psi + prow + at);
      pwp[r] = __ldg(pl.psip + prow + at);
    }
  }
  const size_t th = (size_t)L1 << (L1 - 1);
  col_stages<kLazy, false, L1, 0>(v, ar, pl.tw1 + p * th, pl.twp1 + p * th, i,
                                  smem + c * ((1 << L1) + 1));
  // word o of the column is j1 = o: n1^-1, then psi^-i (negacyclic), to
  // x[j1 n2 + j2], reduced
  const uint32_t wn = pl.ninv1[p], wnp = pl.ninv1p[p];
  uint32_t* oc = out + p * sop + ring * sob + j2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = (size_t)(bl | ((uint32_t)r << gl)) << L2;
    uint32_t w = ar.inv_out(v[r], wn, wnp, !pl.negacyclic);
    if (pl.negacyclic) w = ar.inv_out(w, pw[r], pwp[r], true);
    oc[at] = w;
  }
}

// Columns (C = 2^logc) and rows (2^logr) a block: 32 each, fewer while
// the grid would leave SMs without a block (down to 8: 32-byte runs), and
// never more than kMaxThreads threads.
template <int L1, int L2>
bool widths(long long rings, int& logc, int& logr) {
  constexpr int TPC = 1 << (L1 - kRB);     // threads a column
  const long long sms = host::sm_count();
  logc = 5;
  while ((TPC << logc) > kMaxThreads) --logc;
  while (logc > 3 && (rings << (L2 - logc)) < sms) --logc;
  logr = 5;
  while (logr > 3 && (rings << (L1 - logr)) < sms) --logr;
  return (rings << (L2 - 3)) < (1LL << 31) && (rings << (L1 - 3)) < (1LL << 31);
}

// Shared memory of a row pass: the row exchanges' rows and the (n2, R)
// tile, which are used in turn.
template <int L2>
size_t row_smem(int logr) {
  const size_t exch = (size_t)ntt_regs::row_stride(L2) << logr;
  const size_t tile = (size_t)tile_stride(1 << logr, L2) << L2;
  return sizeof(uint32_t) * (exch > tile ? exch : tile);
}

template <int L1>
size_t col_smem(int logc) {
  return sizeof(uint32_t) * ((size_t)1 << logc) * ((1 << L1) + 1);
}

template <bool kFwd, bool kLazy, int L1, int L2>
int launch(const Args& a) {
  constexpr int TPC = 1 << (L1 - kRB);
  constexpr int TPR = 1 << (L2 - kRB);
  const long long rings = (long long)a.k * a.b;
  int logc, logr;
  if (!widths<L1, L2>(rings, logc, logr)) return (int)cudaErrorInvalidValue;
  const unsigned cols = (unsigned)(rings << (L2 - logc)), rows = (unsigned)(rings << (L1 - logr));
  if constexpr (kFwd) {
    fourstep_cols_kernel<kLazy, L1, L2><<<cols, TPC << logc, col_smem<L1>(logc), a.s>>>(
        a.x, a.scratch, a.pl, a.b, logc, a.sxp, a.sxb);
  } else {
    fourstep_irows_kernel<kLazy, L1, L2><<<rows, TPR << logr, row_smem<L2>(logr), a.s>>>(
        a.x, a.scratch, a.pl, a.b, logr, a.sxp, a.sxb);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if constexpr (kFwd) {
    fourstep_rows_kernel<kLazy, L1, L2><<<rows, TPR << logr, row_smem<L2>(logr), a.s>>>(
        a.scratch, a.out, a.pl, a.b, logr, a.sop, a.sob);
  } else {
    fourstep_icols_kernel<kLazy, L1, L2><<<cols, TPC << logc, col_smem<L1>(logc), a.s>>>(
        a.scratch, a.out, a.pl, a.b, logc, a.sop, a.sob);
  }
  return (int)cudaGetLastError();
}

template <bool kFwd, bool kLazy>
int dispatch(int l1, int l2, const Args& a) {
#define FOURSTEP_SPLIT(A, B) \
  if (l1 == A && l2 == B) return launch<kFwd, kLazy, A, B>(a);
  FOURSTEP_SPLIT(5, 5) FOURSTEP_SPLIT(6, 5) FOURSTEP_SPLIT(6, 6) FOURSTEP_SPLIT(7, 6)
  FOURSTEP_SPLIT(7, 7) FOURSTEP_SPLIT(8, 7) FOURSTEP_SPLIT(8, 8) FOURSTEP_SPLIT(9, 8)
#undef FOURSTEP_SPLIT
  return (int)cudaErrorInvalidValue;
}

template <bool kFwd>
int run(const Args& a, int n1, int n2, int lazy) {
  if (a.k <= 0 || a.b <= 0) return (int)cudaGetLastError();
  const int l1 = ntt_regs::ilog2(n1), l2 = ntt_regs::ilog2(n2);
  if ((1 << l1) != n1 || (1 << l2) != n2) return (int)cudaErrorInvalidValue;
  return lazy ? dispatch<kFwd, true>(l1, l2, a) : dispatch<kFwd, false>(l1, l2, a);
}

const uint32_t* u(const void* p) { return static_cast<const uint32_t*>(p); }

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
  const Plan pl{u(qs), u(psi), u(psip), u(tw1), u(twp1), u(tw), u(twp), u(tw2), u(twp2),
                nullptr, nullptr, nullptr, nullptr, negacyclic != 0};
  const Args a{u(x), static_cast<uint32_t*>(out), static_cast<uint32_t*>(scratch), pl, k, b,
               sxp, sxb, sop, sob, static_cast<cudaStream_t>(stream)};
  return run<true>(a, n1, n2, lazy);
}

// The inverse: x in natural order A[k2 n1 + k1] (any u32 word below 2q when
// lazy, below q else), out in [0, q); the row pass's tables (its inverse
// stages, n2^-1, the inverse twiddle itw), then the column pass's (its
// inverse stages, n1^-1, psi^-i), the rest as ntt_fourstep_banks.
extern "C" int intt_fourstep_banks(const void* x, void* out, void* scratch, const void* qs,
                                   const void* itw2, const void* itwp2, const void* ninv2,
                                   const void* ninv2p, const void* itw, const void* itwp,
                                   const void* itw1, const void* itwp1, const void* ninv1,
                                   const void* ninv1p, const void* ipsi, const void* ipsip,
                                   int k, int b, int n1, int n2, long long sxp, long long sxb,
                                   long long sop, long long sob, int negacyclic, int lazy,
                                   void* stream) {
  const Plan pl{u(qs), u(ipsi), u(ipsip), u(itw1), u(itwp1), u(itw), u(itwp), u(itw2),
                u(itwp2), u(ninv1), u(ninv1p), u(ninv2), u(ninv2p), negacyclic != 0};
  const Args a{u(x), static_cast<uint32_t*>(out), static_cast<uint32_t*>(scratch), pl, k, b,
               sxp, sxb, sop, sob, static_cast<cudaStream_t>(stream)};
  return run<false>(a, n1, n2, lazy);
}
