"""Plain reference of ML-DSA-65 (FIPS 204, Aug 2024): a straightforward
transcription of the standard's ML-DSA.KeyGen_internal (Alg. 6),
ML-DSA.Sign_internal (Alg. 7) and ML-DSA.Verify_internal (Alg. 8) and
the functions they call, in Python integers, with ``hashlib`` for H
(SHAKE256) and G (SHAKE128).  It shares no code with the program under
test (FIPS 204's own NTT network and order, a ``%`` for every reduction,
per-coefficient loops) and imports neither JAX nor the JAX package nor
the port.

Departures from the standard: none in what is computed.  ``sign``
returns, beside the signature, the number of iterations its rejection
loop ran (kappa / l + 1 at the end), which the standard computes and
does not return; an ``MlDsa65`` keeps the matrix of the last rho it
expanded, which changes no result.

``MlDsa65(z_bound=False)`` is the control: Sign_internal with the bound
on ||z|| left out, so a row whose z the standard rejects is accepted (a z
past gamma1 is packed into its 20-bit fields modulo 2^20).
"""
from __future__ import annotations

import hashlib

Q = 8380417
N = 256
ZETA = 1753
D = 13
TAU = 49
LAMBDA = 192
GAMMA1 = 1 << 19
GAMMA2 = (Q - 1) // 32
K = 6
L = 5
ETA = 4
BETA = TAU * ETA
OMEGA = 55

CT_BYTES = LAMBDA // 4                            # 48: c-tilde
Z_BITS = 1 + (GAMMA1 - 1).bit_length()            # 20
W1_BITS = ((Q - 1) // (2 * GAMMA2) - 1).bit_length()   # 4
T1_BITS = (Q - 1).bit_length() - D                # 10
ETA_BITS = (2 * ETA).bit_length()                 # 4
PK_BYTES = 32 + 32 * K * T1_BITS                  # 1952
SK_BYTES = 128 + 32 * ((K + L) * ETA_BITS + K * D)    # 4032
SIG_BYTES = CT_BYTES + 32 * L * Z_BITS + OMEGA + K    # 3309
N_INV = pow(N, Q - 2, Q)                          # 8347681


def _brv8(x: int) -> int:
    return int(f"{x:08b}"[::-1], 2)


ZETAS = [pow(ZETA, _brv8(i), Q) for i in range(N)]


def h(data: bytes, length: int) -> bytes:
    """H: SHAKE256."""
    return hashlib.shake_256(data).digest(length)


class _Stream:
    """An XOF read a few bytes at a time (H.Squeeze / G.Squeeze)."""

    def __init__(self, xof, block: int):
        self.xof, self.block, self.buf, self.pos = xof, block, b"", 0

    def take(self, n: int) -> bytes:
        while self.pos + n > len(self.buf):
            self.buf = self.xof.digest(len(self.buf) + self.block)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


# ------------------------------------------------------------ the ring

def ntt(w: list[int]) -> list[int]:
    """Alg. 41."""
    w = list(w)
    m, ln = 0, 128
    while ln >= 1:
        for start in range(0, N, 2 * ln):
            m += 1
            z = ZETAS[m]
            for j in range(start, start + ln):
                t = z * w[j + ln] % Q
                w[j + ln] = (w[j] - t) % Q
                w[j] = (w[j] + t) % Q
        ln //= 2
    return w


def intt(w: list[int]) -> list[int]:
    """Alg. 42."""
    w = list(w)
    m, ln = N, 1
    while ln < N:
        for start in range(0, N, 2 * ln):
            m -= 1
            z = -ZETAS[m]
            for j in range(start, start + ln):
                t = w[j]
                w[j] = (t + w[j + ln]) % Q
                w[j + ln] = z * (t - w[j + ln]) % Q
        ln *= 2
    return [N_INV * x % Q for x in w]


def pointwise(a: list[int], b: list[int]) -> list[int]:
    """Alg. 45 (MultiplyNTT)."""
    return [x * y % Q for x, y in zip(a, b)]


def add(a: list[int], b: list[int]) -> list[int]:
    return [(x + y) % Q for x, y in zip(a, b)]


def sub(a: list[int], b: list[int]) -> list[int]:
    return [(x - y) % Q for x, y in zip(a, b)]


def mat_vec(a_hat, v_hat) -> list[list[int]]:
    """Alg. 48 (MatrixVectorNTT)."""
    out = []
    for row in a_hat:
        acc = [0] * N
        for a, v in zip(row, v_hat):
            acc = [(s + x * y) % Q for s, x, y in zip(acc, a, v)]
        out.append(acc)
    return out


def mod_pm(r: int, alpha: int) -> int:
    """r mod± alpha: the representative in (-alpha/2, alpha/2] (alpha even)."""
    r %= alpha
    return r - alpha if r > alpha // 2 else r


def inf_norm(vec) -> int:
    """||vec||∞ of polynomials over Z_q, each coefficient taken mod± q."""
    return max(abs(mod_pm(c, Q)) for p in vec for c in p)


def power2round(r: int) -> tuple[int, int]:
    """Alg. 35."""
    rp = r % Q
    r0 = mod_pm(rp, 1 << D)
    return (rp - r0) >> D, r0


def decompose(r: int) -> tuple[int, int]:
    """Alg. 36."""
    rp = r % Q
    r0 = mod_pm(rp, 2 * GAMMA2)
    if rp - r0 == Q - 1:
        return 0, r0 - 1
    return (rp - r0) // (2 * GAMMA2), r0


def high_bits(r: int) -> int:
    """Alg. 37."""
    return decompose(r)[0]


def low_bits(r: int) -> int:
    """Alg. 38."""
    return decompose(r)[1]


def make_hint(z: int, r: int) -> int:
    """Alg. 39."""
    return int(high_bits(r) != high_bits(r + z))


def use_hint(hint: int, r: int) -> int:
    """Alg. 40."""
    m = (Q - 1) // (2 * GAMMA2)
    r1, r0 = decompose(r)
    if hint == 1 and r0 > 0:
        return (r1 + 1) % m
    if hint == 1 and r0 <= 0:
        return (r1 - 1) % m
    return r1


# --------------------------------------------------------- the codecs

def simple_bit_pack(w: list[int], bits: int) -> bytes:
    """Alg. 16: coefficient i in bits [bits*i, bits*(i+1)), least
    significant bit first."""
    v = 0
    for i, c in enumerate(w):
        v |= c << (bits * i)
    return v.to_bytes(32 * bits, "little")


def simple_bit_unpack(buf: bytes, bits: int) -> list[int]:
    """Alg. 18."""
    v = int.from_bytes(buf, "little")
    mask = (1 << bits) - 1
    return [(v >> (bits * i)) & mask for i in range(N)]


def bit_pack(w: list[int], a: int, b: int) -> bytes:
    """Alg. 17: b - w_i in bitlen(a + b) bits."""
    return simple_bit_pack([b - c for c in w], (a + b).bit_length())


def bit_unpack(buf: bytes, a: int, b: int) -> list[int]:
    """Alg. 19."""
    return [b - c for c in simple_bit_unpack(buf, (a + b).bit_length())]


def hint_bit_pack(hint) -> bytes:
    """Alg. 20."""
    y = bytearray(OMEGA + K)
    index = 0
    for i in range(K):
        for j in range(N):
            if hint[i][j]:
                y[index] = j
                index += 1
        y[OMEGA + i] = index
    return bytes(y)


def hint_bit_unpack(y: bytes):
    """Alg. 21: the hint, or None for a malformed encoding."""
    hint = [[0] * N for _ in range(K)]
    index = 0
    for i in range(K):
        if y[OMEGA + i] < index or y[OMEGA + i] > OMEGA:
            return None
        first = index
        while index < y[OMEGA + i]:
            if index > first and y[index - 1] >= y[index]:
                return None
            hint[i][y[index]] = 1
            index += 1
    if any(y[i] for i in range(index, OMEGA)):
        return None
    return hint


def pk_encode(rho: bytes, t1) -> bytes:
    """Alg. 22."""
    return rho + b"".join(simple_bit_pack(p, T1_BITS) for p in t1)


def pk_decode(pk: bytes):
    """Alg. 23."""
    n = 32 * T1_BITS
    return pk[:32], [simple_bit_unpack(pk[32 + n * i:32 + n * (i + 1)], T1_BITS)
                     for i in range(K)]


def sk_encode(rho, key, tr, s1, s2, t0) -> bytes:
    """Alg. 24."""
    return (rho + key + tr + b"".join(bit_pack(p, ETA, ETA) for p in s1)
            + b"".join(bit_pack(p, ETA, ETA) for p in s2)
            + b"".join(bit_pack(p, (1 << (D - 1)) - 1, 1 << (D - 1)) for p in t0))


def sk_decode(sk: bytes):
    """Alg. 25."""
    rho, key, tr = sk[:32], sk[32:64], sk[64:128]
    ne, nt = 32 * ETA_BITS, 32 * D
    o = 128
    s1 = [bit_unpack(sk[o + ne * i:o + ne * (i + 1)], ETA, ETA) for i in range(L)]
    o += ne * L
    s2 = [bit_unpack(sk[o + ne * i:o + ne * (i + 1)], ETA, ETA) for i in range(K)]
    o += ne * K
    t0 = [bit_unpack(sk[o + nt * i:o + nt * (i + 1)], (1 << (D - 1)) - 1, 1 << (D - 1))
          for i in range(K)]
    return rho, key, tr, s1, s2, t0


def sig_encode(c_tilde: bytes, z, hint) -> bytes:
    """Alg. 26."""
    return (c_tilde + b"".join(bit_pack(p, GAMMA1 - 1, GAMMA1) for p in z)
            + hint_bit_pack(hint))


def sig_decode(sig: bytes):
    """Alg. 27: (c-tilde, z, hint), the hint None if malformed."""
    n = 32 * Z_BITS
    z = [bit_unpack(sig[CT_BYTES + n * i:CT_BYTES + n * (i + 1)], GAMMA1 - 1, GAMMA1)
         for i in range(L)]
    return sig[:CT_BYTES], z, hint_bit_unpack(sig[CT_BYTES + n * L:])


def w1_encode(w1) -> bytes:
    """Alg. 28."""
    return b"".join(simple_bit_pack(p, W1_BITS) for p in w1)


# ---------------------------------------------------------- sampling

def sample_in_ball(rho: bytes) -> list[int]:
    """Alg. 29."""
    c = [0] * N
    xof = _Stream(hashlib.shake_256(rho), 136)
    s = int.from_bytes(xof.take(8), "little")
    for i in range(N - TAU, N):
        j = xof.take(1)[0]
        while j > i:
            j = xof.take(1)[0]
        c[i] = c[j]
        c[j] = 1 if (s >> (i + TAU - N)) & 1 == 0 else Q - 1
    return c


def rej_ntt_poly(rho: bytes) -> list[int]:
    """Alg. 30, with Alg. 14 (CoeffFromThreeBytes)."""
    xof = _Stream(hashlib.shake_128(rho), 168)
    a = []
    while len(a) < N:
        b0, b1, b2 = xof.take(3)
        z = ((b2 & 127) << 16) | (b1 << 8) | b0
        if z < Q:
            a.append(z)
    return a


def rej_bounded_poly(rho: bytes) -> list[int]:
    """Alg. 31, with Alg. 15 (CoeffFromHalfByte) at eta = 4: integers in
    [-eta, eta]."""
    xof = _Stream(hashlib.shake_256(rho), 136)
    a = []
    while len(a) < N:
        z = xof.take(1)[0]
        for half in (z & 15, z >> 4):
            if half < 9 and len(a) < N:
                a.append(ETA - half)
    return a


def expand_a(rho: bytes):
    """Alg. 32: Â[r][s] = RejNTTPoly(rho || s || r), in FIPS 204's NTT
    order."""
    return [[rej_ntt_poly(rho + bytes([s, r])) for s in range(L)] for r in range(K)]


def expand_s(rho: bytes):
    """Alg. 33."""
    s1 = [rej_bounded_poly(rho + r.to_bytes(2, "little")) for r in range(L)]
    s2 = [rej_bounded_poly(rho + (r + L).to_bytes(2, "little")) for r in range(K)]
    return s1, s2


def expand_mask(rho: bytes, mu: int):
    """Alg. 34: y[r] = BitUnpack(H(rho || mu + r, 32 * 20), gamma1 - 1,
    gamma1), as residues mod q."""
    return [[c % Q for c in bit_unpack(h(rho + (mu + r).to_bytes(2, "little"), 32 * Z_BITS),
                                       GAMMA1 - 1, GAMMA1)] for r in range(L)]


# ------------------------------------------------------------ ML-DSA

class MlDsa65:
    """ML-DSA-65's internal functions; ``z_bound=False`` runs the control."""

    def __init__(self, z_bound: bool = True):
        self.z_bound = z_bound
        self._a = (None, None)               # the last (rho, Â)

    def _expand_a(self, rho: bytes):
        if self._a[0] != rho:
            self._a = (rho, expand_a(rho))
        return self._a[1]

    @staticmethod
    def keygen(xi: bytes) -> tuple[bytes, bytes]:
        """Alg. 6 (ML-DSA.KeyGen_internal): (pk, sk)."""
        seed = h(xi + bytes([K, L]), 128)
        rho, rho_p, key = seed[:32], seed[32:96], seed[96:]
        a_hat = expand_a(rho)
        s1, s2 = expand_s(rho_p)
        t = [add(intt(p), e) for p, e in
             zip(mat_vec(a_hat, [ntt([c % Q for c in s]) for s in s1]), s2)]
        t1 = [[power2round(c)[0] for c in p] for p in t]
        t0 = [[power2round(c)[1] for c in p] for p in t]
        pk = pk_encode(rho, t1)
        return pk, sk_encode(rho, key, h(pk, 64), s1, s2, t0)

    def sign(self, sk: bytes, msg: bytes, rnd: bytes) -> tuple[bytes, int]:
        """Alg. 7 (ML-DSA.Sign_internal) on M' = ``msg``: (signature,
        iterations of the rejection loop)."""
        rho, key, tr, s1, s2, t0 = sk_decode(sk)
        s1_hat = [ntt([c % Q for c in p]) for p in s1]
        s2_hat = [ntt([c % Q for c in p]) for p in s2]
        t0_hat = [ntt([c % Q for c in p]) for p in t0]
        a_hat = self._expand_a(rho)
        mu = h(tr + msg, 64)
        rho_pp = h(key + rnd + mu, 64)
        kappa = 0
        while True:
            y = expand_mask(rho_pp, kappa)
            w = [intt(p) for p in mat_vec(a_hat, [ntt(p) for p in y])]
            w1 = [[high_bits(c) for c in p] for p in w]
            c_tilde = h(mu + w1_encode(w1), CT_BYTES)
            c_hat = ntt(sample_in_ball(c_tilde))
            cs1 = [intt(pointwise(c_hat, p)) for p in s1_hat]
            cs2 = [intt(pointwise(c_hat, p)) for p in s2_hat]
            z = [[mod_pm(a + b, Q) for a, b in zip(p, e)] for p, e in zip(y, cs1)]
            r = [sub(p, e) for p, e in zip(w, cs2)]
            r0 = [[low_bits(c) for c in p] for p in r]
            iterations = kappa // L + 1
            kappa += L
            if (self.z_bound and inf_norm(z) >= GAMMA1 - BETA) or \
                    max(abs(c) for p in r0 for c in p) >= GAMMA2 - BETA:
                continue
            ct0 = [intt(pointwise(c_hat, p)) for p in t0_hat]
            hint = [[make_hint((-a) % Q, b + a) for a, b in zip(p, e)]
                    for p, e in zip(ct0, r)]
            if inf_norm(ct0) >= GAMMA2 or sum(map(sum, hint)) > OMEGA:
                continue
            if not self.z_bound:       # the control's z may pass gamma1: its 20-bit
                z = [[GAMMA1 - (GAMMA1 - c) % (1 << Z_BITS) for c in p] for p in z]  # fields wrap
            return sig_encode(c_tilde, z, hint), iterations

    def verify(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        """Alg. 8 (ML-DSA.Verify_internal) on M' = ``msg``."""
        if len(pk) != PK_BYTES or len(sig) != SIG_BYTES:
            return False
        rho, t1 = pk_decode(pk)
        c_tilde, z, hint = sig_decode(sig)
        if hint is None:
            return False
        a_hat = self._expand_a(rho)
        mu = h(h(pk, 64) + msg, 64)
        c_hat = ntt(sample_in_ball(c_tilde))
        az = mat_vec(a_hat, [ntt([c % Q for c in p]) for p in z])
        ct1 = [pointwise(c_hat, ntt([(c << D) % Q for c in p])) for p in t1]
        w_approx = [intt(sub(a, b)) for a, b in zip(az, ct1)]
        w1 = [[use_hint(g, c) for g, c in zip(hp, p)] for hp, p in zip(hint, w_approx)]
        return inf_norm(z) < GAMMA1 - BETA and h(mu + w1_encode(w1), CT_BYTES) == c_tilde
