// Degree-1 basecase product of an incomplete ring for Hopper (sm_90a).
//
// Replaces the TPU kernel dyadic_basemul_banks of
// src/repro/kernels/dyadic_kernel.py (_basemul_banks_kernel): ML-KEM's
// NTT-domain product.  Pair j of the CG-ordered domain is
// (x[j], x[j + n/2]), and the product mod (X^2 - gamma_j) is
//
//   c0[j] = a0*b0 + gamma_j*(a1*b1)      c1[j] = a0*b1 + a1*b0
//
// on the 16-bit lane (uint16_t storage, int16 bit patterns in PyTorch):
// the variable x variable products use the 16-bit Barrett reduction, the
// gamma multiply the 16-bit Shoup one with the precomputed gammap row.
// The lazy mode keeps its sums in the [0, 2q) band (4q < 2^16); the
// epilogue always reduces to [0, q), since the basecase ends the NTT
// domain's algebra and has no lazy consumer.
//
// What bounds it on an H100: at ML-KEM's sizes, the card's fixed cost
// per launch and the instructions.  Each pair reads four u16 words and
// writes two (12 bytes; the largest call, 9 * 256 rows of 256 words,
// moves 3.5 MB, 1.06 us at 3.35 TB/s); the gamma rows (n/2 words each)
// stay in L1.  A pair compiles to 57 integer instructions (four Barrett
// products, a Shoup product, the band sums, the u16 halves taken from
// and packed into 32-bit words, the item's indices; lazy, k = 1), 1.0 us
// at that size on 132 x 64 lanes at 1980 MHz, and an empty kernel
// already takes 1.5-1.8 us a call (tools/time_basemul.py, PERF.md).
//
// What the design does about it:
// - Vector body (basemul_vec_kernel): a thread takes one item of kPairs
//   = 2 consecutive pairs j, j + 1 of one row: one 32-bit load each of
//   a0, a1, b0, b1 (words j .. and j + n/2 ..) and of the gamma and
//   gammap words that line up with them (read-only path), and two 32-bit
//   stores; a warp's access is 128 contiguous bytes.  The u16 words are
//   taken by halves and packed back with one __byte_perm.  Measured on an
//   H100 (PERF.md, PR 20): 2 pairs a thread in blocks of 128 beat 4 and 8
//   pairs (8- and 16-byte accesses: longer serial chains on fewer warps)
//   and 64 or 256 threads at every path shape.  The row's prime p =
//   row / B (rows of one prime are contiguous) is a 32-bit division an
//   item, and none in the k = 1 instantiation (ML-KEM).  Grid-strided:
//   one item a thread up to one wave of resident blocks (at every
//   ML-KEM shape), a loop above it.  Its sums stay below 2^32 (fewer
//   than 2^31 items).
// - Pair body (basemul_pair_kernel): one thread a pair with 2-byte
//   accesses, for what the vector body does not take: n = 2, an operand
//   or a gamma row not 4-byte aligned (a view at an odd word), or 2^31
//   items or more.  plan() chooses the body by shape and pointers; a
//   failed launch is returned to the wrapper either way.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "host.cuh"
#include "modarith.cuh"

using namespace modarith;

namespace {

using host::sm_count;

constexpr int kPairs = 2;           // pairs an item of the vector body holds
constexpr int kVecThreads = 128;    // a block of the vector body
constexpr int kWaveBlocks = 16;     // its resident blocks a SM (2048 threads): one wave
constexpr int kMaxThreads = 256;    // the most threads a block of either body
constexpr int kPairThreads = 256;   // a block of the pair body
constexpr long long kMaxPairBlocks = 1 << 20;  // blocks the pair body starts (they loop)
constexpr long long kMaxItems = 1LL << 31;     // the vector body counts items in 32 bits

// c0, c1 of one pair in [0, q): the reference's op sequence, each
// s >= m ? s - m : s written min(s, s - m) as in modarith.cuh.
template <bool kLazy>
__device__ __forceinline__ void basemul_pair(uint32_t a0, uint32_t a1, uint32_t b0,
                                             uint32_t b1, uint32_t g, uint32_t gp,
                                             uint32_t q, uint32_t mu, uint32_t& c0,
                                             uint32_t& c1) {
  if constexpr (kLazy) {
    const uint32_t q2 = q << 1;
    const uint32_t t = shoup16_lazy(barrett16_lazy(a1, b1, q, mu), g, gp, q);
    const uint32_t s0 = barrett16_lazy(a0, b0, q, mu) + t;  // < 4q
    const uint32_t s1 = barrett16_lazy(a0, b1, q, mu) + barrett16_lazy(a1, b0, q, mu);
    c0 = min(s0, s0 - q2);
    c1 = min(s1, s1 - q2);
    c0 = min(c0, c0 - q);  // epilogue
    c1 = min(c1, c1 - q);
  } else {
    const uint32_t t = shoup16(barrett16(a1, b1, q, mu), g, gp, q);
    const uint32_t s0 = barrett16(a0, b0, q, mu) + t;
    const uint32_t s1 = barrett16(a0, b1, q, mu) + barrett16(a1, b0, q, mu);
    c0 = min(s0, s0 - q);
    c1 = min(s1, s1 - q);
  }
}

// kW 32-bit words (2 kW u16 words) moved as one access (kW = 1 here;
// tools/basemul_probe.cu adds 2 and 4 for the variants it times)
template <int kW>
struct Words;
template <>
struct Words<1> {
  union {
    uint32_t v;
    uint32_t w[1];
  };
};

template <int kW>
__device__ __forceinline__ Words<kW> load_words(const uint16_t* p) {
  Words<kW> x;
  x.v = __ldg(reinterpret_cast<const decltype(x.v)*>(p));
  return x;
}

// Items of kP pairs over (k * B rows) x (2^log_vpr items a row), in
// rows of n = 2 * kP * 2^log_vpr words; thread t of the grid's T takes
// the items t, t + T, ... (fewer than 2^31 items, so no sum wraps).
// kOnePrime: k = 1, every row's prime is 0.
template <bool kLazy, int kP, bool kOnePrime>
__global__ void __launch_bounds__(kMaxThreads)
basemul_vec_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                   uint16_t* __restrict__ out, const uint16_t* __restrict__ qs,
                   const uint16_t* __restrict__ mus, const uint16_t* __restrict__ gamma,
                   const uint16_t* __restrict__ gammap, unsigned bsz, int log_vpr,
                   unsigned items) {
  constexpr int kW = kP / 2;
  const unsigned h = (unsigned)kP << log_vpr;  // pairs a row
#pragma unroll 1
  for (unsigned it = blockIdx.x * blockDim.x + threadIdx.x; it < items;
       it += gridDim.x * blockDim.x) {
    const unsigned row = it >> log_vpr;
    const unsigned j = (it & ((1u << log_vpr) - 1)) * kP;  // the item's first pair
    const unsigned p = kOnePrime ? 0u : row / bsz;
    const size_t at = (size_t)row * (2 * h) + j;
    const size_t gat = (size_t)p * h + j;
    const Words<kW> a0 = load_words<kW>(a + at), a1 = load_words<kW>(a + at + h);
    const Words<kW> b0 = load_words<kW>(b + at), b1 = load_words<kW>(b + at + h);
    const Words<kW> g = load_words<kW>(gamma + gat), gp = load_words<kW>(gammap + gat);
    const uint32_t q = __ldg(qs + p), mu = __ldg(mus + p);
    Words<kW> c0, c1;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      uint32_t l0, l1, u0, u1;  // pair j + 2i (low halves), j + 2i + 1 (high)
      basemul_pair<kLazy>(a0.w[i] & 0xFFFFu, a1.w[i] & 0xFFFFu, b0.w[i] & 0xFFFFu,
                          b1.w[i] & 0xFFFFu, g.w[i] & 0xFFFFu, gp.w[i] & 0xFFFFu, q, mu,
                          l0, l1);
      basemul_pair<kLazy>(a0.w[i] >> 16, a1.w[i] >> 16, b0.w[i] >> 16, b1.w[i] >> 16,
                          g.w[i] >> 16, gp.w[i] >> 16, q, mu, u0, u1);
      c0.w[i] = __byte_perm(l0, u0, 0x5410);
      c1.w[i] = __byte_perm(l1, u1, 0x5410);
    }
    *reinterpret_cast<decltype(c0.v)*>(out + at) = c0.v;
    *reinterpret_cast<decltype(c1.v)*>(out + at + h) = c1.v;
  }
}

// One thread a pair over (k * B rows) x (h = 2^log_h pairs), grid-strided.
template <bool kLazy>
__global__ void __launch_bounds__(kMaxThreads)
basemul_pair_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                    uint16_t* __restrict__ out, const uint16_t* __restrict__ qs,
                    const uint16_t* __restrict__ mus, const uint16_t* __restrict__ gamma,
                    const uint16_t* __restrict__ gammap, int bsz, int log_h,
                    long long total) {
  const int h = 1 << log_h;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx & (h - 1));
    const long long row = idx >> log_h;  // over k * B rows
    const int p = (int)(row / bsz);
    const long long base = row << (log_h + 1);  // row * n
    uint32_t c0, c1;
    basemul_pair<kLazy>(a[base + j], a[base + j + h], b[base + j], b[base + j + h],
                        gamma[(size_t)p * h + j], gammap[(size_t)p * h + j], qs[p], mus[p],
                        c0, c1);
    out[base + j] = (uint16_t)c0;
    out[base + j + h] = (uint16_t)c1;
  }
}

int ilog2(long long n) {
  int s = 0;
  while ((1LL << s) < n) ++s;
  return s;
}

// A launch: the body, the pairs an item holds (1 in the pair body), its
// block size, its items and its blocks.
struct Plan {
  int vec;
  int pairs;
  int threads;
  long long items;
  long long grid;
};

// The vector body for n/2 a multiple of kPairs, every row and gamma
// pointer aligned to an item's 2 * kPairs bytes and fewer than 2^31
// items: one item a thread up to one wave of resident blocks
// (kWaveBlocks a SM), whose threads loop above it; the pair body
// otherwise.  `sms`: the card's SMs.
Plan plan(int k, int bsz, int n, bool aligned, int sms) {
  const long long rows = (long long)k * bsz;
  const int h = n / 2;
  if (h % kPairs == 0 && aligned && rows * (h / kPairs) < kMaxItems) {
    const long long items = rows * (h / kPairs);
    const long long need = (items + kVecThreads - 1) / kVecThreads;
    const long long wave = (long long)sms * kWaveBlocks;
    return {1, kPairs, kVecThreads, items, need < wave ? need : wave};
  }
  const long long items = rows * h;
  const long long need = (items + kPairThreads - 1) / kPairThreads;
  return {0, 1, kPairThreads, items, need < kMaxPairBlocks ? need : kMaxPairBlocks};
}

// The vector body with items of kP pairs on plan pl's grid.
template <bool kLazy, int kP>
void launch_vec(const Plan& pl, const uint16_t* a, const uint16_t* b, uint16_t* out,
                const uint16_t* qs, const uint16_t* mus, const uint16_t* gamma,
                const uint16_t* gammap, int k, int bsz, int n, cudaStream_t s) {
  auto kernel = k == 1 ? &basemul_vec_kernel<kLazy, kP, true>
                       : &basemul_vec_kernel<kLazy, kP, false>;
  kernel<<<(unsigned)pl.grid, pl.threads, 0, s>>>(a, b, out, qs, mus, gamma, gammap,
                                                  (unsigned)bsz, ilog2(n / 2 / kP),
                                                  (unsigned)pl.items);
}

template <bool kLazy>
int launch(const Plan& pl, const uint16_t* a, const uint16_t* b, uint16_t* out,
           const uint16_t* qs, const uint16_t* mus, const uint16_t* gamma,
           const uint16_t* gammap, int k, int bsz, int n, cudaStream_t s) {
  if (pl.vec) {
    launch_vec<kLazy, kPairs>(pl, a, b, out, qs, mus, gamma, gammap, k, bsz, n, s);
  } else {
    basemul_pair_kernel<kLazy><<<(unsigned)pl.grid, pl.threads, 0, s>>>(
        a, b, out, qs, mus, gamma, gammap, bsz, ilog2(n / 2), pl.items);
  }
  return (int)cudaGetLastError();
}

// every row and gamma pointer aligned to `bytes`
bool all_aligned(int bytes, const void* a, const void* b, const void* out,
                 const void* gamma, const void* gammap) {
  for (const void* p : {a, b, out, gamma, gammap})
    if (reinterpret_cast<uintptr_t>(p) % bytes) return false;
  return true;
}

}  // namespace

// Returns cudaGetLastError() of its launch; the Python wrapper raises on a
// non-zero code.  Shapes are checked by the wrapper: a, b, out (k, b, n)
// with n a power of two >= 2; qs, mus (k,); gamma, gammap (k, n/2); all
// uint16 (int16 bit patterns), contiguous.
extern "C" int dyadic_basemul_banks(const void* a, const void* b, void* out,
                                    const void* qs, const void* mus,
                                    const void* gamma, const void* gammap,
                                    int k, int bsz, int n, int lazy,
                                    void* stream) {
  const Plan pl = plan(k, bsz, n, all_aligned(2 * kPairs, a, b, out, gamma, gammap),
                       sm_count());
  if (pl.items <= 0) return (int)cudaGetLastError();
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint16_t*>(a);
  const auto* pb = static_cast<const uint16_t*>(b);
  auto* po = static_cast<uint16_t*>(out);
  const auto* pq = static_cast<const uint16_t*>(qs);
  const auto* pm = static_cast<const uint16_t*>(mus);
  const auto* pg = static_cast<const uint16_t*>(gamma);
  const auto* pgp = static_cast<const uint16_t*>(gammap);
  return lazy ? launch<true>(pl, pa, pb, po, pq, pm, pg, pgp, k, bsz, n, s)
              : launch<false>(pl, pa, pb, po, pq, pm, pg, pgp, k, bsz, n, s);
}

// The launch plan() makes on a card of `sms` SMs, as out[0..4] = {vector
// body, pairs an item, threads a block, items, blocks}: the schedule the
// tests emulate.  Returns 0.
extern "C" int dyadic_basemul_plan(int k, int bsz, int n, int aligned, int sms,
                                   long long* out) {
  const Plan pl = plan(k, bsz, n, aligned != 0, sms);
  out[0] = pl.vec;
  out[1] = pl.pairs;
  out[2] = pl.threads;
  out[3] = pl.items;
  out[4] = pl.grid;
  return 0;
}
