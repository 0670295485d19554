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
// and five for ML-DSA-65 (FIPS 204): keccak_expand_mask (ExpandMask fused
// with its 20-bit BitUnpack, the signing loop's 5 streams a slot),
// keccak_sample_in_ball, keccak_rej_ntt_poly (ExpandA) and
// keccak_rej_bounded (ExpandS) for the key, and keccak_mu_rho, the
// signing stream's refill hashes, gated by a count on the device.
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
// time (any row stride and alignment; about a fifth of H(ek)'s work), a
// lane wholly inside a or inside b at once, the padding's a byte at a
// time.  The
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
      } else if (k0 >= a_len && k0 + 8 <= a_len + b_len) {
        w = load_lane(m.b + (k0 - a_len));   // inside b (ML-DSA's w1 after mu)
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

// ------------------------------------------------------------ ML-DSA
// FIPS 204's samplers (ML-DSA-65, q = 8380417) and the signing stream's
// refill hashes.  Outputs are int32 residues mod q.

constexpr uint32_t kDsaQ = 8380417;
constexpr int kDsaK = 6, kDsaL = 5;
constexpr int kDsaTau = 49;
constexpr int kGamma1 = 1 << 19;
constexpr int kMaskWords = 160;              // an ExpandMask stream: 640 bytes
constexpr int kMaskStride = kMaskWords + 1;  // odd: threads' words on other banks

// ExpandMask (FIPS 204 Alg. 34) fused with its BitUnpack: one SHAKE256
// stream a thread for each (slot, r), rho || IntegerToBytes(kappa + r, 2),
// squeezed to 640 bytes (5 permutations) into the thread's words in shared
// memory; then the block unpacks its streams' 20-bit fields with adjacent
// threads on adjacent coefficients and stores gamma1 - v mod q.
__global__ void __launch_bounds__(kStage)
    expand_mask_kernel(const uint8_t* rho, long long rho_stride, const int32_t* kappa,
                       int32_t* out, long long streams) {
  __shared__ uint32_t words[kStage * kMaskStride];
  const long long first = static_cast<long long>(blockIdx.x) * kStage;
  const long long stream = first + threadIdx.x;
  if (stream < streams) {
    const long long slot = stream / kDsaL;
    const int r = static_cast<int>(stream - slot * kDsaL);
    uint64_t s[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) s[l] = 0;
    const uint8_t* p = rho + slot * rho_stride;
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = load_lane(p + 8 * l);
    // rho || kappa + r (2 bytes), SHAKE's 0x1F at byte 66 and 0x80 at byte 135
    const uint32_t nonce = static_cast<uint32_t>(kappa[slot] + r) & 0xFFFFu;
    s[8] = static_cast<uint64_t>(nonce) | (0x1FULL << 16);
    s[16] = 0x80ULL << 56;
    uint32_t* mine = words + threadIdx.x * kMaskStride;
#pragma unroll 1
    for (int blk = 0; blk < 5; ++blk) {
      keccak_f(s);
#pragma unroll
      for (int l = 0; l < 17; ++l) {
        const int w = blk * 34 + 2 * l;
        if (w < kMaskWords) {
          mine[w] = static_cast<uint32_t>(s[l]);
          mine[w + 1] = static_cast<uint32_t>(s[l] >> 32);
        }
      }
    }
  }
  __syncthreads();
  const int n = static_cast<int>(min(static_cast<long long>(kStage), streams - first));
  for (int i = threadIdx.x; i < n * kN; i += kStage) {
    const int t = i / kN, c = i % kN;
    const uint32_t* mine = words + t * kMaskStride;
    const int bit = 20 * c;   // the pad word closes the last field's pair
    const uint64_t v = (mine[bit >> 5] | (static_cast<uint64_t>(mine[(bit >> 5) + 1]) << 32)) >>
                       (bit & 31);
    const int y = kGamma1 - static_cast<int>(v & 0xFFFFFu);
    out[(first + t) * kN + c] = y < 0 ? y + static_cast<int>(kDsaQ) : y;
  }
}

// The rate-136 lanes of a state as 34 words
__device__ __forceinline__ void stash136(const uint64_t s[25], uint32_t* w) {
#pragma unroll
  for (int l = 0; l < 17; ++l) {
    w[2 * l] = static_cast<uint32_t>(s[l]);
    w[2 * l + 1] = static_cast<uint32_t>(s[l] >> 32);
  }
}

// SampleInBall (FIPS 204 Alg. 29): one SHAKE256 stream of c-tilde a
// thread; 8 sign bytes, then a byte a candidate j (taken when j <= i),
// squeezing a further block when one runs out.  A row's 49 swaps run on
// its own 256 bytes in shared memory (0, 1 for +1, 2 for -1), read a
// squeezed block's bytes from shared memory too (the state's lanes must
// stay at constant register indices), and the block copies its rows out
// with adjacent threads on adjacent coefficients.
constexpr int kBall = 64;
__global__ void __launch_bounds__(kBall)
    sample_in_ball_kernel(const uint8_t* ct, long long ct_stride, int32_t* out, int rows) {
  __shared__ uint8_t coef[kBall][kN];
  __shared__ uint32_t squeezed[kBall][35];
  const int first = blockIdx.x * kBall;
  const int row = first + threadIdx.x;
  uint8_t* c = coef[threadIdx.x];
#pragma unroll 8
  for (int i = 0; i < kN; i += 4) *reinterpret_cast<uint32_t*>(c + i) = 0;
  if (row < rows) {
    uint64_t s[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) s[l] = 0;
    const uint8_t* p = ct + static_cast<long long>(row) * ct_stride;
#pragma unroll
    for (int l = 0; l < 6; ++l) s[l] = load_lane(p + 8 * l);
    // c-tilde's 48 bytes, SHAKE's 0x1F at byte 48 and 0x80 at byte 135
    s[6] = 0x1FULL;
    s[16] = 0x80ULL << 56;
    keccak_f(s);
    const uint64_t signs = s[0];
    stash136(s, squeezed[threadIdx.x]);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(squeezed[threadIdx.x]);
    int pos = 8;
    for (int i = kN - kDsaTau; i < kN; ++i) {
      int j;
      do {
        if (pos == 136) {
          keccak_f(s);
          stash136(s, squeezed[threadIdx.x]);
          pos = 0;
        }
        j = bytes[pos++];
      } while (j > i);
      c[i] = c[j];
      c[j] = static_cast<uint8_t>(1 + ((signs >> (i + kDsaTau - kN)) & 1));
    }
  }
  __syncthreads();
  const int n = min(kBall, rows - first);
  for (int i = threadIdx.x; i < n * kN; i += kBall) {
    const int t = i / kN, col = i % kN;
    const uint32_t v = coef[t][col];
    out[static_cast<long long>(first + t) * kN + col] =
        v == 0 ? 0 : (v == 1 ? 1 : static_cast<int>(kDsaQ) - 1);
  }
}

// The 24-bit field F of a 24-byte squeeze group in lanes w0 .. w2
// (fields 2 and 5 straddle two lanes)
template <int F>
__device__ __forceinline__ uint32_t field24(uint64_t w0, uint64_t w1, uint64_t w2) {
  constexpr int bit = 24 * F;
  if constexpr (bit + 24 <= 64) {
    return static_cast<uint32_t>(w0 >> bit) & 0xFFFFFFu;
  } else if constexpr (bit < 64) {
    return static_cast<uint32_t>((w0 >> bit) | (w1 << (64 - bit))) & 0xFFFFFFu;
  } else if constexpr (bit + 24 <= 128) {
    return static_cast<uint32_t>(w1 >> (bit - 64)) & 0xFFFFFFu;
  } else if constexpr (bit < 128) {
    return static_cast<uint32_t>((w1 >> (bit - 64)) | (w2 << (128 - bit))) & 0xFFFFFFu;
  } else {
    return static_cast<uint32_t>(w2 >> (bit - 128)) & 0xFFFFFFu;
  }
}

// RejNTTPoly's candidates of one group: CoeffFromThreeBytes (the top
// bit of the third byte cleared), taken below q while fewer than 256 were
template <int F>
__device__ __forceinline__ void take_fields23(uint64_t w0, uint64_t w1, uint64_t w2, int& count,
                                              int32_t* row) {
  const uint32_t d = field24<F>(w0, w1, w2) & 0x7FFFFFu;
  const bool ok = d < kDsaQ && count < kN;
  if (ok) row[count] = static_cast<int32_t>(d);
  count += ok;
  if constexpr (F + 1 < 8) take_fields23<F + 1>(w0, w1, w2, count, row);
}

// ExpandA (FIPS 204 Alg. 32): one SHAKE128 stream a thread for each (row,
// r, s), rho || s || r, squeezed until 256 candidates below q were taken
// (5 blocks at least).  A key's matrix is made once (keygen, a stream's
// set-up), so each thread stores its own row's words.
__global__ void __launch_bounds__(kThreads)
    rej_ntt_poly_kernel(const uint8_t* rho, long long rho_stride, int32_t* out,
                        long long streams) {
  const long long stream = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (stream >= streams) return;
  const long long row = stream / (kDsaK * kDsaL);
  const int rs = static_cast<int>(stream - row * (kDsaK * kDsaL));
  const int r = rs / kDsaL, col = rs - kDsaL * (rs / kDsaL);
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  const uint8_t* p = rho + row * rho_stride;
#pragma unroll
  for (int l = 0; l < 4; ++l) s[l] = load_lane(p + 8 * l);
  // rho || s || r, SHAKE's 0x1F at byte 34 and 0x80 at byte 167
  s[4] = static_cast<uint64_t>(col) | (static_cast<uint64_t>(r) << 8) | (0x1FULL << 16);
  s[20] = 0x80ULL << 56;
  int32_t* o = out + stream * kN;
  int count = 0;
  while (count < kN) {
    keccak_f(s);
#pragma unroll
    for (int g = 0; g < 7; ++g) take_fields23<0>(s[3 * g], s[3 * g + 1], s[3 * g + 2], count, o);
  }
}

// RejBoundedPoly at eta = 4 (FIPS 204 Alg. 31): a half-byte h below 9 is
// taken as 4 - h mod q, the low half of a byte first
__device__ __forceinline__ void take_half(uint32_t h, int& count, int32_t* row) {
  const bool ok = h < 9 && count < kN;
  if (ok) row[count] = h <= 4 ? static_cast<int32_t>(4 - h) : static_cast<int32_t>(kDsaQ + 4 - h);
  count += ok;
}

// ExpandS (FIPS 204 Alg. 33): one SHAKE256 stream a thread for each (row,
// c), rho' || IntegerToBytes(n0 + c, 2), squeezed until 256 were taken
__global__ void __launch_bounds__(kThreads)
    rej_bounded_kernel(const uint8_t* rho, long long rho_stride, int n0, int count, int32_t* out,
                       long long streams) {
  const long long stream = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (stream >= streams) return;
  const long long row = stream / count;
  const int c = static_cast<int>(stream - row * count);
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  const uint8_t* p = rho + row * rho_stride;
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = load_lane(p + 8 * l);
  s[8] = static_cast<uint64_t>((n0 + c) & 0xFFFF) | (0x1FULL << 16);
  s[16] = 0x80ULL << 56;
  int32_t* o = out + stream * kN;
  int got = 0;
  while (got < kN) {
    keccak_f(s);
#pragma unroll
    for (int l = 0; l < 17; ++l) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t byte = static_cast<uint32_t>(s[l] >> (8 * k)) & 0xFFu;
        take_half(byte & 15u, got, o);
        take_half(byte >> 4, got, o);
      }
    }
  }
}

// SHAKE256 of a || b || c, out_len <= 136 bytes; message bytes gathered
// one at a time (any alignment)
__device__ void shake256_parts(const uint8_t* a, int la, const uint8_t* b, int lb,
                               const uint8_t* c, int lc, uint8_t* out, int out_len) {
  const int len = la + lb + lc;
  const int blocks = len / 136 + 1;
  const int padded = blocks * 136;
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  for (int blk = 0; blk < blocks; ++blk) {
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      uint64_t w = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int at = blk * 136 + 8 * l + k;
        uint32_t v = 0;
        if (at < la) {
          v = a[at];
        } else if (at < la + lb) {
          v = b[at - la];
        } else if (at < len) {
          v = c[at - la - lb];
        }
        if (at == len) v ^= 0x1Fu;
        if (at == padded - 1) v ^= 0x80u;
        w |= static_cast<uint64_t>(v) << (8 * k);
      }
      s[l] ^= w;
    }
    keccak_f(s);
  }
#pragma unroll
  for (int l = 0; l < 17; ++l) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (8 * l + k < out_len) out[8 * l + k] = static_cast<uint8_t>(s[l] >> (8 * k));
    }
  }
}

// The signing stream's refill: entry i < *count takes request reqs[i] into
// slot slots[i]: mu = H(tr || M', 64), then rho'' = H(K || rnd || mu, 64)
// (FIPS 204 Alg. 7, lines 6-7).  The count lives on the device, so the
// launch covers every slot and threads past it return at once.
__global__ void __launch_bounds__(kThreads)
    mu_rho_kernel(const uint8_t* tr, const uint8_t* key, const uint8_t* msg, long long msg_stride,
                  int msg_len, const uint8_t* rnd, long long rnd_stride, const long long* slots,
                  const long long* reqs, const long long* count, uint8_t* mu_out,
                  uint8_t* rho_out, int rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows || i >= *count) return;
  const long long slot = slots[i], req = reqs[i];
  uint8_t* mu = mu_out + slot * 64;
  shake256_parts(tr, 64, msg + req * msg_stride, msg_len, nullptr, 0, mu, 64);
  shake256_parts(key, 32, rnd + req * rnd_stride, 32, mu, 64, rho_out + slot * 64, 64);
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

// out (rows, 5, 256) int32: ExpandMask(rho[s], kappa[s]) mod q.
extern "C" int keccak_expand_mask(const void* rho, long long rho_stride, const void* kappa,
                                  void* out, int rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long streams = static_cast<long long>(kDsaL) * rows;
  expand_mask_kernel<<<blocks_for(streams, kStage), kStage, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rho), rho_stride, static_cast<const int32_t*>(kappa),
      static_cast<int32_t*>(out), streams);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, 256) int32: SampleInBall(ct[r]) as 0, 1 and q - 1.
extern "C" int keccak_sample_in_ball(const void* ct, long long ct_stride, void* out, int rows,
                                     void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  sample_in_ball_kernel<<<blocks_for(rows, kBall), kBall, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ct), ct_stride, static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, 6, 5, 256) int32: ExpandA(rho[r]).
extern "C" int keccak_rej_ntt_poly(const void* rho, long long rho_stride, void* out, int rows,
                                   void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long streams = static_cast<long long>(kDsaK * kDsaL) * rows;
  rej_ntt_poly_kernel<<<blocks_for(streams, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rho), rho_stride, static_cast<int32_t*>(out), streams);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, count, 256) int32: RejBoundedPoly(rho[r] || n0 + c) mod q.
extern "C" int keccak_rej_bounded(const void* rho, long long rho_stride, int n0, int count,
                                  void* out, int rows, void* stream) {
  if (rows <= 0 || count <= 0) return static_cast<int>(cudaGetLastError());
  const long long streams = static_cast<long long>(count) * rows;
  rej_bounded_kernel<<<blocks_for(streams, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rho), rho_stride, n0, count, static_cast<int32_t*>(out),
      streams);
  return static_cast<int>(cudaGetLastError());
}

// The refill hashes of the first *count of `rows` entries (slots, reqs,
// count int64 on the device); mu_out and rho_out rows of 64 bytes.
extern "C" int keccak_mu_rho(const void* tr, const void* key, const void* msg,
                             long long msg_stride, int msg_len, const void* rnd,
                             long long rnd_stride, const void* slots, const void* reqs,
                             const void* count, void* mu_out, void* rho_out, int rows,
                             void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  mu_rho_kernel<<<blocks_for(rows, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tr), static_cast<const uint8_t*>(key),
      static_cast<const uint8_t*>(msg), msg_stride, msg_len, static_cast<const uint8_t*>(rnd),
      rnd_stride, static_cast<const long long*>(slots), static_cast<const long long*>(reqs),
      static_cast<const long long*>(count), static_cast<uint8_t*>(mu_out),
      static_cast<uint8_t*>(rho_out), rows);
  return static_cast<int>(cudaGetLastError());
}
