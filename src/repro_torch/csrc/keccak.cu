// Keccak-f[1600] (FIPS 202) and the sponge front ends of ML-KEM (FIPS 203)
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference hashes on the host with hashlib
// (src/repro/pq/mlkem.py _g, _h, _j, _prf, _sample_ntt).  It was added so
// that a batch of ML-KEM operations runs on the card from its input bytes
// to its output bytes, with nothing waiting on the host.  Three launchers:
//
// - keccak_hash: one sponge a row over the row's bytes a || b || extra
//   (two strided byte rows and an optional byte), at rate 72 (SHA3-512),
//   136 (SHA3-256, SHAKE256) or 168 (SHAKE128), domain byte 0x06 (SHA3)
//   or 0x1F (SHAKE), squeezing out_len bytes (as many blocks as that
//   takes).  ML-KEM's H, G and J.
// - keccak_sample_ntt: FIPS 203 Alg. 7 SampleNTT, one SHAKE128 stream a
//   thread for each (row, i, j), absorbing rho || j || i and squeezing
//   blocks of 168 bytes until 256 candidates below q were taken (three
//   blocks at least, a fourth for about one stream in 120), in the kernel
//   with no host sync.  The coefficients go straight to the CG order of
//   the port's NTT domain (FIPS index 2b + p -> (p << 7) | b), at
//   A[i][j] or, with transpose, at A[j][i].
// - keccak_prf_cbd: FIPS 203 PRF_2 (SHAKE256 of s || N, 128 bytes)
//   fused with SamplePolyCBD_2, one stream a thread: coefficient i is
//   nibble i of the stream, (bit0 + bit1) - (bit2 + bit3) mod q.
//
// What bounds it on an H100: the integer instructions of the
// permutation.  A round is theta (10 three-input XORs of the column sums,
// 5 rotations, 25 three-input XORs applying them), rho (24 rotations),
// chi (25 three-input logic functions) and iota (1): 90 operations on
// 64-bit lanes, each 2 INT32 instructions on 32-bit halves (a rotation is
// two funnel shifts), so a permutation is at least 24 * 90 * 2 = 4320
// instructions; an encapsulation needs 44 permutations (9 for H(ek), 1
// for G, 27 for SampleNTT's 9 streams, 7 for the PRF), 0.37 ms at b =
// 32768 on 132 x 64 INT32 lanes at 1980 MHz.  The bytes are small beside
// that (1.2 KB in and 1.6 KB out a row).
//
// What the design does about it: one stream a thread with its 25 lanes in
// registers (every lane index a compile-time constant: the rate is a
// template parameter, the rotations are unrolled constants, and the
// SampleNTT and CBD fields are taken by constant shifts), so a round is
// the ALU work alone.  Message bytes are gathered into lanes a byte at a
// time (any row stride and alignment; about a fifth of H(ek)'s work).  The
// sampler takes a candidate with one predicated 2-byte store into its
// row in shared memory, at the CG position, and no branch; the sampler
// and the CBD copy their block's rows out with adjacent threads on
// adjacent words.  Measured on an H100 at b = 32768 (PERF.md, rows
// 19-21), the sampler's first design, a thread storing its own row's
// words straight to global memory through a switch on the candidate's
// place, took 0.97 ms; staged, 0.37.  The CBD's unrolled loop took 254
// registers; it is held to 128 (8 blocks of 64 a SM).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kN = 256;            // ML-KEM's ring
constexpr uint32_t kQ = 3329;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

template <int R>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  return (x << R) | (x >> (64 - R));
}

// rho and pi together: lane 1's value walks the pi cycle, each lane
// taking its predecessor rotated by its rho offset
#define KECCAK_RP(j, r)          \
  {                              \
    const uint64_t s_ = a[j];    \
    a[j] = rotl<r>(t);           \
    t = s_;                      \
  }

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[y + x] ^= d;
    }
    uint64_t t = a[1];
    KECCAK_RP(10, 1) KECCAK_RP(7, 3) KECCAK_RP(11, 6) KECCAK_RP(17, 10)
    KECCAK_RP(18, 15) KECCAK_RP(3, 21) KECCAK_RP(5, 28) KECCAK_RP(16, 36)
    KECCAK_RP(8, 45) KECCAK_RP(21, 55) KECCAK_RP(24, 2) KECCAK_RP(4, 14)
    KECCAK_RP(15, 27) KECCAK_RP(23, 41) KECCAK_RP(19, 56) KECCAK_RP(13, 8)
    KECCAK_RP(12, 25) KECCAK_RP(2, 43) KECCAK_RP(20, 62) KECCAK_RP(14, 18)
    KECCAK_RP(22, 39) KECCAK_RP(9, 61) KECCAK_RP(6, 20) KECCAK_RP(1, 44)
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint64_t b[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) b[x] = a[y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x) a[y + x] = b[x] ^ (~b[(x + 1) % 5] & b[(x + 2) % 5]);
    }
    a[0] ^= kRC[round];
  }
}

#undef KECCAK_RP

// 8 bytes of a row, little-endian, from any alignment
__device__ __forceinline__ uint64_t load_lane(const uint8_t* p) {
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w |= static_cast<uint64_t>(p[k]) << (8 * k);
  return w;
}

// The message a || b || extra of one row, with the sponge's padding:
// byte(k) is byte k of the padded input of `blocks` blocks of `rate`.
struct Message {
  const uint8_t* a;
  const uint8_t* b;
  int a_len, b_len, extra, suffix, len, padded;

  __device__ __forceinline__ uint32_t byte(int k) const {
    uint32_t v = 0;
    if (k < a_len) {
      v = a[k];
    } else if (k < a_len + b_len) {
      v = b[k - a_len];
    } else if (k < len) {
      v = static_cast<uint32_t>(extra);
    }
    if (k == len) v ^= static_cast<uint32_t>(suffix);
    if (k == padded - 1) v ^= 0x80u;
    return v;
  }
};

template <int RATE>
__global__ void __launch_bounds__(kThreads)
    keccak_hash_kernel(const uint8_t* a, long long a_stride, int a_len, const uint8_t* b,
                       long long b_stride, int b_len, int extra, int suffix, uint8_t* out,
                       int out_len, int rows) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  Message m;
  m.a = a + row * a_stride;
  m.b = b + row * b_stride;
  m.a_len = a_len;
  m.b_len = b_len;
  m.extra = extra;
  m.suffix = suffix;
  m.len = a_len + b_len + (extra >= 0 ? 1 : 0);
  const int blocks = m.len / RATE + 1;
  m.padded = blocks * RATE;
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  for (int blk = 0; blk < blocks; ++blk) {
    const int base = blk * RATE;
#pragma unroll
    for (int l = 0; l < RATE / 8; ++l) {
      const int k0 = base + 8 * l;
      uint64_t w;
      if (k0 + 8 <= a_len) {
        w = load_lane(m.a + k0);       // the common case: inside a
      } else {
        w = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) w |= static_cast<uint64_t>(m.byte(k0 + k)) << (8 * k);
      }
      s[l] ^= w;
    }
    keccak_f(s);
  }
  uint8_t* o = out + static_cast<long long>(row) * out_len;
  for (int off = 0; off < out_len; off += RATE) {
    if (off) keccak_f(s);
#pragma unroll
    for (int l = 0; l < RATE / 8; ++l) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = off + 8 * l + k;
        if (p < out_len) o[p] = static_cast<uint8_t>(s[l] >> (8 * k));
      }
    }
  }
}

// The 12-bit field F of a 24-byte squeeze group held in lanes w0 .. w2
// (fields 5 and 10 straddle two lanes)
template <int F>
__device__ __forceinline__ uint32_t field12(uint64_t w0, uint64_t w1, uint64_t w2) {
  constexpr int bit = 12 * F;
  if constexpr (bit + 12 <= 64) {
    return static_cast<uint32_t>(w0 >> bit) & 0xFFFu;
  } else if constexpr (bit < 64) {
    return static_cast<uint32_t>((w0 >> bit) | (w1 << (64 - bit))) & 0xFFFu;
  } else if constexpr (bit + 12 <= 128) {
    return static_cast<uint32_t>(w1 >> (bit - 64)) & 0xFFFu;
  } else if constexpr (bit < 128) {
    return static_cast<uint32_t>((w1 >> (bit - 64)) | (w2 << (128 - bit))) & 0xFFFu;
  } else {
    return static_cast<uint32_t>(w2 >> (bit - 128)) & 0xFFFu;
  }
}

// The squeezing kernels stage a block's output rows in shared memory and
// copy them out with adjacent threads on adjacent words: a thread's own
// row is 512 bytes, so its stores straight to global memory would touch a
// line a thread.  A stream's 128 words are padded by one, so threads at
// the same coefficient write to different banks.
constexpr int kStage = 64;             // streams (threads) a block
constexpr int kRowWords = kN / 2 + 1;

// Block rows 0 .. n - 1 from the stage to out rows dst[r], 128 words each
__device__ __forceinline__ void copy_out(const uint32_t* stage, const long long* dst, int n,
                                         int16_t* out) {
  for (int w = threadIdx.x; w < n * (kN / 2); w += kStage) {
    const int r = w / (kN / 2), c = w % (kN / 2);
    reinterpret_cast<uint32_t*>(out + dst[r] * kN)[c] = stage[r * kRowWords + c];
  }
}

// One SampleNTT candidate: taken while fewer than 256 were, at the CG
// position of FIPS index `count` (2b + p -> (p << 7) | b)
__device__ __forceinline__ void take(uint32_t d, int& count, uint16_t* row) {
  const bool ok = d < kQ && count < kN;
  if (ok) row[((count & 1) << 7) | (count >> 1)] = static_cast<uint16_t>(d);
  count += ok;
}

template <int F>
__device__ __forceinline__ void take_fields(uint64_t w0, uint64_t w1, uint64_t w2, int& count,
                                            uint16_t* row) {
  take(field12<F>(w0, w1, w2), count, row);
  if constexpr (F + 1 < 16) take_fields<F + 1>(w0, w1, w2, count, row);
}

__global__ void __launch_bounds__(kStage)
    sample_ntt_kernel(const uint8_t* rho, long long rho_stride, int16_t* out, int rows,
                      int transpose) {
  __shared__ uint32_t stage[kStage * kRowWords];
  __shared__ long long dst[kStage];
  const long long first = static_cast<long long>(blockIdx.x) * kStage;
  const long long stream = first + threadIdx.x;
  const long long streams = 9LL * rows;
  if (stream < streams) {
    const long long row = stream / 9;
    const int ij = static_cast<int>(stream - 9 * row);
    const int i = ij / 3, j = ij - 3 * (ij / 3);
    uint64_t s[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) s[l] = 0;
    const uint8_t* r = rho + row * rho_stride;
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = load_lane(r + 8 * l);
    // rho || j || i, SHAKE's 0x1F at byte 34 and 0x80 at byte 167 of the
    // 168-byte block
    s[4] = static_cast<uint64_t>(j) | (static_cast<uint64_t>(i) << 8) | (0x1FULL << 16);
    s[20] = 0x80ULL << 56;
    dst[threadIdx.x] = 9 * row + (transpose ? 3 * j + i : ij);
    auto* mine = reinterpret_cast<uint16_t*>(stage + threadIdx.x * kRowWords);
    int count = 0;
    while (count < kN) {
      keccak_f(s);
#pragma unroll
      for (int g = 0; g < 7; ++g) take_fields<0>(s[3 * g], s[3 * g + 1], s[3 * g + 2], count, mine);
    }
  }
  __syncthreads();
  copy_out(stage, dst, static_cast<int>(min(static_cast<long long>(kStage), streams - first)),
           out);
}

__global__ void __launch_bounds__(kStage, 8)
    prf_cbd_kernel(const uint8_t* seed, long long seed_stride, int n0, int count,
                   int16_t* out, int rows) {
  __shared__ uint32_t stage[kStage * kRowWords];
  __shared__ long long dst[kStage];
  const long long first = static_cast<long long>(blockIdx.x) * kStage;
  const long long stream = first + threadIdx.x;
  const long long streams = static_cast<long long>(count) * rows;
  if (stream < streams) {
    const long long row = stream / count;
    const int c = static_cast<int>(stream - row * count);
    uint64_t s[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) s[l] = 0;
    const uint8_t* p = seed + row * seed_stride;
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = load_lane(p + 8 * l);
    // s || N, SHAKE's 0x1F at byte 33 and 0x80 at byte 135 of the 136-byte block
    s[4] = static_cast<uint64_t>((n0 + c) & 0xFF) | (0x1FULL << 8);
    s[16] = 0x80ULL << 56;
    keccak_f(s);
    dst[threadIdx.x] = stream;
    uint32_t* mine = stage + threadIdx.x * kRowWords;
#pragma unroll
    for (int w = 0; w < kN / 2; ++w) {       // coefficients 2w and 2w + 1: a byte
      const uint32_t byte = static_cast<uint32_t>(s[w >> 3] >> (8 * (w & 7))) & 0xFFu;
      uint32_t pair = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t nib = byte >> (4 * e);
        const int d = static_cast<int>((nib & 1u) + ((nib >> 1) & 1u)) -
                      static_cast<int>(((nib >> 2) & 1u) + ((nib >> 3) & 1u));
        pair |= static_cast<uint32_t>(d < 0 ? d + static_cast<int>(kQ) : d) << (16 * e);
      }
      mine[w] = pair;
    }
  }
  __syncthreads();
  copy_out(stage, dst, static_cast<int>(min(static_cast<long long>(kStage), streams - first)),
           out);
}

int blocks_for(long long threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

}  // namespace

// out (rows, out_len) bytes: the sponge of rate `rate` (72, 136 or 168)
// over a[r] || b[r] || extra (b_len 0: no b; extra < 0: no byte) with the
// domain byte `suffix`.  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for another rate.
extern "C" int keccak_hash(const void* a, long long a_stride, int a_len, const void* b,
                           long long b_stride, int b_len, int extra, int rate, int suffix,
                           void* out, int out_len, int rows, void* stream) {
  if (rows <= 0 || out_len <= 0) return static_cast<int>(cudaGetLastError());
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = b ? static_cast<const uint8_t*>(b) : pa;
  auto* po = static_cast<uint8_t*>(out);
  const int grid = blocks_for(rows, kThreads);
  switch (rate) {
    case 72:
      keccak_hash_kernel<72><<<grid, kThreads, 0, s>>>(pa, a_stride, a_len, pb, b_stride, b_len,
                                                      extra, suffix, po, out_len, rows);
      break;
    case 136:
      keccak_hash_kernel<136><<<grid, kThreads, 0, s>>>(pa, a_stride, a_len, pb, b_stride,
                                                       b_len, extra, suffix, po, out_len, rows);
      break;
    case 168:
      keccak_hash_kernel<168><<<grid, kThreads, 0, s>>>(pa, a_stride, a_len, pb, b_stride,
                                                       b_len, extra, suffix, po, out_len, rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (rows, 3, 3, 256) int16: SampleNTT(rho[r] || j || i) in CG order at
// [r, i, j], or at [r, j, i] with transpose.  out 4-byte aligned.
extern "C" int keccak_sample_ntt(const void* rho, long long rho_stride, void* out, int rows,
                                 int transpose, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  sample_ntt_kernel<<<blocks_for(9LL * rows, kStage), kStage, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rho), rho_stride, static_cast<int16_t*>(out), rows,
      transpose);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, count, 256) int16: CBD_2(PRF_2(seed[r], n0 + c)) at [r, c].
// out 4-byte aligned.
extern "C" int keccak_prf_cbd(const void* seed, long long seed_stride, int n0, int count,
                              void* out, int rows, void* stream) {
  if (rows <= 0 || count <= 0) return static_cast<int>(cudaGetLastError());
  prf_cbd_kernel<<<blocks_for(static_cast<long long>(count) * rows, kStage), kStage, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const uint8_t*>(seed),
                                                       seed_stride, n0, count,
                                                       static_cast<int16_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
