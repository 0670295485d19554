// ML-KEM's byte codecs around encryption (FIPS 203 Alg. 5, 6, 14) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference encodes and decodes on the host
// in numpy (src/repro/pq/mlkem.py byte_encode, byte_decode, compress).
// Two launchers, one block a row:
//
// - mlkem_decode_check: ByteDecode12 of the key's 1152 bytes of t̂ into
//   the port's CG order (byte triple t of polynomial i holds FIPS
//   coefficients 2t and 2t + 1: CG positions t and 128 + t), reduced mod
//   q, and FIPS 203 §7.2's modulus check a row: ByteEncode12(ByteDecode12
//   (ek)) == ek exactly when no 12-bit field is q or above.
// - mlkem_encaps_tail: the end of K-PKE.Encrypt and of Encaps: u = u' +
//   e1 and v = v' + e2 + Decompress1(m) mod q, Compress10 / Compress4 and
//   ByteEncode10 / ByteEncode4 into the 1088-byte ciphertext, K from G's
//   first 32 bytes, and a row whose key failed the check zeroed.
//
// What bounds it on an H100: the bytes.  The check reads 1.2 KB a row and
// writes 1.5 KB; the tail reads 4 KB and writes 1.1 KB: at b = 32768, 88
// and 166 MB, 26 and 50 us at 3.35 TB/s.  The arithmetic is a few
// operations a coefficient (the compress division is by a constant).
//
// What the design does about it: a thread takes a byte triple (the
// check) or a group of 4 coefficients (the tail, 5 ciphertext bytes for
// u, 2 for v), so a warp reads and writes adjacent bytes of its row.  The
// check's verdict is one __syncthreads_or a block.  The PyTorch chain it
// replaces (kernels/ref.py) ran some twenty elementwise passes over int32
// and int64 copies of the same rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 256;
constexpr int kK = 3;                  // ML-KEM-768's rank
constexpr int kQ = 3329;
constexpr int kDecodeThreads = 128;
constexpr int kTailThreads = 256;
constexpr int kUBytes = 32 * 10 * kK;  // 960
constexpr int kCtBytes = kUBytes + 32 * 4;

__device__ __forceinline__ uint32_t compress(uint32_t x, int d) {
  return (((x << (d + 1)) + kQ) / (2 * kQ)) & ((1u << d) - 1);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= kQ ? s - kQ : s;
}

__global__ void __launch_bounds__(kDecodeThreads)
    decode_check_kernel(const uint8_t* ek, long long ek_stride, int16_t* t_hat, uint8_t* ok) {
  const long long row = blockIdx.x;
  const uint8_t* src = ek + row * ek_stride;
  int16_t* dst = t_hat + row * (kK * kN);
  int bad = 0;
  for (int t = threadIdx.x; t < kK * kN / 2; t += kDecodeThreads) {
    const uint32_t b0 = src[3 * t], b1 = src[3 * t + 1], b2 = src[3 * t + 2];
    const uint32_t d1 = b0 | ((b1 & 15u) << 8), d2 = (b1 >> 4) | (b2 << 4);
    bad |= (d1 >= kQ) | (d2 >= kQ);
    const int poly = t / (kN / 2), j = t % (kN / 2);
    dst[poly * kN + j] = static_cast<int16_t>(d1 >= kQ ? d1 - kQ : d1);
    dst[poly * kN + kN / 2 + j] = static_cast<int16_t>(d2 >= kQ ? d2 - kQ : d2);
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) ok[row] = bad ? 0 : 1;
}

__global__ void __launch_bounds__(kTailThreads)
    encaps_tail_kernel(const int16_t* u, const int16_t* v, const int16_t* e, const uint8_t* m,
                       long long m_stride, const uint8_t* kr, long long kr_stride,
                       const uint8_t* ok, uint8_t* key, uint8_t* ct) {
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const bool keep = ok == nullptr || ok[row] != 0;
  uint8_t* c = ct + row * kCtBytes;
  const int16_t* er = e + row * (kK + 1) * kN;
  if (t < kK * kN / 4) {                 // u: 4 coefficients -> 5 bytes
    const int poly = t / (kN / 4), g = t % (kN / 4);
    const int16_t* ur = u + row * kK * kN + poly * kN + 4 * g;
    const int16_t* e1 = er + poly * kN + 4 * g;
    uint64_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = add_mod(static_cast<uint16_t>(ur[i]), static_cast<uint16_t>(e1[i]));
      w |= static_cast<uint64_t>(compress(x, 10)) << (10 * i);
    }
    uint8_t* o = c + poly * 320 + 5 * g;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = keep ? static_cast<uint8_t>(w >> (8 * i)) : 0;
  } else {                               // v: 4 coefficients -> 2 bytes
    const int g = t - kK * kN / 4;
    const int16_t* vr = v + row * kN + 4 * g;
    const int16_t* e2 = er + kK * kN + 4 * g;
    const uint32_t bits = m[row * m_stride + g / 2] >> (4 * (g % 2));
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t mu = ((bits >> i) & 1u) * ((kQ + 1) / 2);      // Decompress1
      const uint32_t x = add_mod(add_mod(static_cast<uint16_t>(vr[i]),
                                         static_cast<uint16_t>(e2[i])), mu);
      w |= compress(x, 4) << (4 * i);
    }
    c[kUBytes + 2 * g] = keep ? static_cast<uint8_t>(w) : 0;
    c[kUBytes + 2 * g + 1] = keep ? static_cast<uint8_t>(w >> 8) : 0;
  }
  if (key != nullptr && t < 32) key[row * 32 + t] = keep ? kr[row * kr_stride + t] : 0;
}

}  // namespace

// t_hat (rows, 3, 256) int16 in CG order, mod q; ok (rows,) uint8: 1 where
// every 12-bit field of the row's key is below q.
extern "C" int mlkem_decode_check(const void* ek, long long ek_stride, void* t_hat, void* ok,
                                  int rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  decode_check_kernel<<<rows, kDecodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ek), ek_stride, static_cast<int16_t*>(t_hat),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// ct (rows, 1088) and key (rows, 32) uint8 from u (rows, 3, 256) and v
// (rows, 256) int16 in [0, q), e (rows, 4, 256) int16 (e1, then e2), m
// and kr rows (strided); ok (rows,) uint8 or null (every row kept); key
// null: no key written.
extern "C" int mlkem_encaps_tail(const void* u, const void* v, const void* e, const void* m,
                                 long long m_stride, const void* kr, long long kr_stride,
                                 const void* ok, void* key, void* ct, int rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  encaps_tail_kernel<<<rows, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(u), static_cast<const int16_t*>(v),
      static_cast<const int16_t*>(e), static_cast<const uint8_t*>(m), m_stride,
      static_cast<const uint8_t*>(kr), kr_stride, static_cast<const uint8_t*>(ok),
      static_cast<uint8_t*>(key), static_cast<uint8_t*>(ct));
  return static_cast<int>(cudaGetLastError());
}
