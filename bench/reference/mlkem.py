"""Plain reference of ML-KEM-768 (FIPS 203, Aug 2024): a straightforward
transcription of the standard's pseudocode in Python integers, with
``hashlib`` for H, G, J, PRF and XOF, and the encapsulation key check of
§7.2.  It shares no code with the program under test (another NTT
network and order, another reduction, per-coefficient loops) and imports
neither JAX nor the JAX package nor the port.

``MlKem768(lowp=True)`` is the control: the basecase product's sum of
two products rounded to float32 (a 24-bit mantissa; each product of two
residues below q = 3329 fits it, their sum often does not) before its
reduction mod q, the nearest lower precision in which the ring's
arithmetic can be run at all.
"""
from __future__ import annotations

import hashlib
import struct

Q = 3329
N = 256
K = 3
ETA1 = 2
ETA2 = 2
DU = 10
DV = 4
EK_BYTES = 384 * K + 32
CT_BYTES = 32 * (DU * K + DV)


def _bitrev7(x: int) -> int:
    r = 0
    for _ in range(7):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


ZETAS = [pow(17, _bitrev7(i), Q) for i in range(128)]
GAMMAS = [pow(17, 2 * _bitrev7(i) + 1, Q) for i in range(128)]


def _float32(x: int) -> int:
    """x rounded to the nearest float32 (ties to even)."""
    return int(struct.unpack("f", struct.pack("f", float(x)))[0])


def ntt(f: list[int]) -> list[int]:
    """Alg. 9."""
    f = list(f)
    k = 1
    ln = 128
    while ln >= 2:
        for start in range(0, N, 2 * ln):
            z = ZETAS[k]
            k += 1
            for j in range(start, start + ln):
                t = z * f[j + ln] % Q
                f[j + ln] = (f[j] - t) % Q
                f[j] = (f[j] + t) % Q
        ln //= 2
    return f


def intt(f: list[int]) -> list[int]:
    """Alg. 10."""
    f = list(f)
    k = 127
    ln = 2
    while ln <= 128:
        for start in range(0, N, 2 * ln):
            z = ZETAS[k]
            k -= 1
            for j in range(start, start + ln):
                t = f[j]
                f[j] = (t + f[j + ln]) % Q
                f[j + ln] = z * (f[j + ln] - t) % Q
        ln *= 2
    return [x * 3303 % Q for x in f]    # 3303 = 128^-1 mod q


def sample_ntt(seed: bytes) -> list[int]:
    """Alg. 7: rejection sampling from SHAKE128, squeezing on demand."""
    xof = hashlib.shake_128(seed)
    need = 3 * 168
    while True:
        buf = xof.digest(need)
        out = []
        for o in range(0, len(buf) - 2, 3):
            d1 = buf[o] + 256 * (buf[o + 1] % 16)
            d2 = (buf[o + 1] // 16) + 16 * buf[o + 2]
            for d in (d1, d2):
                if d < Q and len(out) < N:
                    out.append(d)
            if len(out) == N:
                return out
        need += 168


def sample_cbd(eta: int, buf: bytes) -> list[int]:
    """Alg. 8."""
    bits = [(byte >> i) & 1 for byte in buf for i in range(8)]
    f = []
    for i in range(N):
        x = sum(bits[2 * i * eta + j] for j in range(eta))
        y = sum(bits[2 * i * eta + eta + j] for j in range(eta))
        f.append((x - y) % Q)
    return f


def byte_encode(d: int, f: list[int]) -> bytes:
    """Alg. 5."""
    bits = [(a >> j) & 1 for a in f for j in range(d)]
    out = bytearray(32 * d)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def byte_decode(d: int, buf: bytes) -> list[int]:
    """Alg. 6 (mod q for d = 12)."""
    bits = [(byte >> i) & 1 for byte in buf for i in range(8)]
    m = Q if d == 12 else 1 << d
    return [sum(bits[i * d + j] << j for j in range(d)) % m for i in range(N)]


def compress(d: int, x: int) -> int:
    return ((x * (1 << (d + 1)) + Q) // (2 * Q)) % (1 << d)


def decompress(d: int, y: int) -> int:
    return (Q * y + (1 << (d - 1))) >> d


def modulus_check(ek: bytes) -> bool:
    """§7.2's encapsulation key check: ByteEncode12(ByteDecode12(ek)) == ek
    on the key's 384k bytes of t̂ (with its length, type checked by the
    caller's (b, 1184) rows)."""
    t = ek[:384 * K]
    return b"".join(byte_encode(12, byte_decode(12, t[384 * i:384 * (i + 1)]))
                    for i in range(K)) == t


class MlKem768:
    """ML-KEM-768's encapsulation; ``lowp`` runs the control."""

    def __init__(self, lowp: bool = False):
        self.lowp = lowp

    def basemul(self, f: list[int], g: list[int]) -> list[int]:
        """Alg. 11 (MultiplyNTTs) with Alg. 12 (BaseCaseMultiply)."""
        add = (lambda a, b: _float32(a + b)) if self.lowp else (lambda a, b: a + b)
        h = [0] * N
        for i in range(128):
            a0, a1 = f[2 * i], f[2 * i + 1]
            b0, b1 = g[2 * i], g[2 * i + 1]
            h[2 * i] = add(a0 * b0, a1 * b1 % Q * GAMMAS[i]) % Q
            h[2 * i + 1] = add(a0 * b1, a1 * b0) % Q
        return h

    def k_pke_encrypt(self, ek: bytes, m: bytes, r: bytes) -> bytes:
        """Alg. 14."""
        t_hat = [byte_decode(12, ek[384 * i:384 * (i + 1)]) for i in range(K)]
        rho = ek[384 * K:]
        a = [[sample_ntt(rho + bytes([j, i])) for j in range(K)] for i in range(K)]
        prf = lambda n: hashlib.shake_256(r + bytes([n])).digest(64 * ETA1)
        y = [sample_cbd(ETA1, prf(i)) for i in range(K)]
        e1 = [sample_cbd(ETA2, prf(K + i)) for i in range(K)]
        e2 = sample_cbd(ETA2, prf(2 * K))
        y_hat = [ntt(v) for v in y]
        u = []
        for i in range(K):
            acc = [0] * N
            for j in range(K):
                p = self.basemul(a[j][i], y_hat[j])      # A transposed
                acc = [(x + v) % Q for x, v in zip(acc, p)]
            u.append([(x + v) % Q for x, v in zip(intt(acc), e1[i])])
        mu = [decompress(1, b) for b in byte_decode(1, m)]
        acc = [0] * N
        for j in range(K):
            p = self.basemul(t_hat[j], y_hat[j])
            acc = [(x + v) % Q for x, v in zip(acc, p)]
        v = [(x + a2 + b2) % Q for x, a2, b2 in zip(intt(acc), e2, mu)]
        c1 = b"".join(byte_encode(DU, [compress(DU, x) for x in ui]) for ui in u)
        c2 = byte_encode(DV, [compress(DV, x) for x in v])
        return c1 + c2

    def encaps(self, ek: bytes, m: bytes) -> tuple[bool, bytes, bytes]:
        """Alg. 17 (ML-KEM.Encaps_internal) behind §7.2's check: (passes,
        K, ct), with zero K and ct for a key that fails it."""
        if len(ek) != EK_BYTES or not modulus_check(ek):
            return False, bytes(32), bytes(CT_BYTES)
        g = hashlib.sha3_512(m + hashlib.sha3_256(ek).digest()).digest()
        return True, g[:32], self.k_pke_encrypt(ek, m, g[32:])
