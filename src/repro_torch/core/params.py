"""NTT parameter generation (host-side numpy, exact integer math).

NTT-friendly primes, roots of unity and the per-stage constant-geometry
twiddle tables with their Shoup companions.  The stage-t table row holds
the 2^t distinct twiddles of that stage expanded to n/2 entries — the
materialized form of the paper's circulating CSRM of length 2^t
(§VI.B.2).  The arrays are uint32 numpy; ``repro_torch.convert`` moves
them onto a device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.modmath import (SHOUP_SHIFT, barrett_precompute,
                                      montgomery_precompute)

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid for all n < 3.3e24."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(count: int, n: int, bits: int = 30) -> list[int]:
    """``count`` primes p with p ≡ 1 (mod 2n), p < 2^bits, descending."""
    step = 2 * n
    p = ((1 << bits) - 1) // step * step + 1
    out: list[int] = []
    while len(out) < count and p > (1 << (bits - 1)):
        if is_prime(p):
            out.append(p)
        p -= step
    if len(out) < count:
        raise ValueError(f"not enough {bits}-bit NTT primes for n={n}")
    return out


def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def primitive_root(q: int) -> int:
    phi = q - 1
    fs = _factorize(phi)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in fs):
            return g
    raise ValueError("no primitive root")


def root_of_unity(order: int, q: int) -> int:
    """A primitive ``order``-th root of unity mod q (order | q-1)."""
    if (q - 1) % order != 0:
        raise ValueError(
            f"root_of_unity: modulus q={q} has no order-{order} root "
            f"(need order | q-1; q-1 = {q - 1} leaves remainder "
            f"{(q - 1) % order})")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    if not (pow(w, order, q) == 1 and pow(w, order // 2, q) != 1):
        raise ValueError(
            f"root_of_unity: derived w={w} is not a primitive order-"
            f"{order} root mod q={q}")
    return w


def bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bitrev_perm(n: int) -> np.ndarray:
    s = n.bit_length() - 1
    return np.array([bitrev(i, s) for i in range(n)], dtype=np.int64)


def fourstep_split(n: int) -> tuple[int, int]:
    """Balanced (n1, n2) power-of-two factorization, n1 >= n2 (paper §IX:
    2^14 = 128 x 128)."""
    s = n.bit_length() - 1
    if n != 1 << s:
        raise ValueError(f"fourstep_split: n={n} is not a power of two")
    n1 = 1 << (s - s // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def galois_coeff_tables(g: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather form of the coefficient-domain automorphism sigma_g
    (X^t -> X^(g t mod 2n), X^n = -1): out[j] = +c[src[j]] where pos[j],
    else -c[src[j]].  The one t reaching output j has g*t = j or j + n
    (mod 2n): t1 = g^-1 * j mod 2n is below n on the + branch and
    t1 - n (sign flip from X^n = -1) otherwise."""
    ginv = pow(g, -1, 2 * n)
    t1 = (ginv * np.arange(n, dtype=np.int64)) % (2 * n)
    return t1 % n, t1 < n


@functools.lru_cache(maxsize=None)
def galois_eval_perm(g: int, n: int, natural: bool) -> np.ndarray:
    """NTT-domain automorphism as a pure slot permutation: out = in[perm].

    Slot j of a negacyclic NTT row holds the evaluation at
    psi^(1 + 2*ord(j)), ord(j) = bitrev(j) for the single-kernel rows and
    ord(j) = j for the ``natural`` four-step rows.  sigma_g maps the
    evaluation at root r to the one at r^g, so perm[j] is the slot that
    holds psi^(g*(1 + 2*ord(j)) mod 2n).  No sign corrections: in the
    evaluation domain the automorphism is a bijection on roots, the same
    for every prime, so the device op is one gather."""
    order = np.arange(n, dtype=np.int64) if natural else bitrev_perm(n)
    m = ((g * (1 + 2 * order)) % (2 * n) - 1) // 2
    return order[m]


def cg_twiddle_exponents(n: int) -> np.ndarray:
    """(log2 n, n/2) exponents of the Pease CG-DIT network: stage t uses
    w_t[j] = omega ** (bitrev(j mod 2^t, t) * n/2^(t+1))."""
    s = n.bit_length() - 1
    exps = np.zeros((s, n // 2), dtype=np.int64)
    for t in range(s):
        for j in range(n // 2):
            exps[t, j] = bitrev(j % (1 << t), t) * (n >> (t + 1))
    return exps


def shoup_table(w: np.ndarray, q: int) -> np.ndarray:
    """Elementwise Shoup companions floor(w * 2^32 / q) as uint32.  Exact
    in uint64: w < q < 2^30, so w << 32 < 2^62."""
    w64 = np.asarray(w).astype(np.uint64)
    return ((w64 << np.uint64(SHOUP_SHIFT)) // np.uint64(q)).astype(np.uint32)


def _pow_row(base: int, count: int, q: int, start: int = 1) -> np.ndarray:
    """[start * base^i mod q for i < count] as uint64 (products < 2^60)."""
    out = np.empty(count, dtype=np.uint64)
    v = start % q
    for i in range(count):
        out[i] = v
        v = v * base % q
    return out


@dataclasses.dataclass(frozen=True)
class NTTParams:
    """Everything a device-side NTT/iNTT needs, for one prime q."""
    n: int
    q: int
    omega: int                  # primitive n-th root (cyclic NTT)
    psi: int                    # primitive 2n-th root (negacyclic wrap)
    tw: np.ndarray              # (s, n/2) u32 forward twiddles
    twp: np.ndarray             # (s, n/2) u32 Shoup companions
    itw: np.ndarray             # (s, n/2) u32 inverse twiddles (w^-1)
    itwp: np.ndarray            # (s, n/2) u32
    ninv: int                   # n^-1 mod q
    ninv_p: int                 # Shoup companion of ninv
    psi_pows: np.ndarray        # (n,) psi^i — negacyclic pre-weight
    psi_pows_p: np.ndarray
    ipsi_ninv: np.ndarray       # (n,) psi^-i * n^-1 — fused post-weight
    ipsi_ninv_p: np.ndarray
    barrett_mu: int
    mont_qinv_neg: int
    mont_r2: int

    @property
    def stages(self) -> int:
        return self.n.bit_length() - 1


@functools.lru_cache(maxsize=None)
def make_ntt_params(n: int, q: int | None = None, bits: int = 30,
                    psi: int | None = None) -> NTTParams:
    """``psi`` override: the four-step decomposition (paper §IX) needs the
    sub-NTT roots to be specific powers of the big transform's root."""
    if q is None:
        q = gen_ntt_primes(1, n, bits)[0]
    if (q - 1) % (2 * n) != 0:
        raise ValueError(
            f"make_ntt_params: modulus q={q} is not NTT-friendly for "
            f"n={n} (need q ≡ 1 mod 2n = {2 * n}; "
            f"q-1 mod 2n = {(q - 1) % (2 * n)})")
    if psi is None:
        psi = root_of_unity(2 * n, q)
    if not (pow(psi, 2 * n, q) == 1 and pow(psi, n, q) != 1):
        raise ValueError(
            f"make_ntt_params: psi={psi} does not have exact order "
            f"2n={2 * n} mod q={q}")
    omega = pow(psi, 2, q)

    exps = cg_twiddle_exponents(n)
    opow = _pow_row(omega, n, q)
    tw = opow[exps]
    # omega^-e = omega^(n-e): the inverse twiddle table is a gather too
    itw = opow[(n - exps) % n]

    ninv = pow(n, q - 2, q)
    psi_pows = _pow_row(psi, n, q)
    ipsi_ninv = _pow_row(pow(psi, q - 2, q), n, q, start=ninv)

    qinv_neg, r2 = montgomery_precompute(q)
    mu = barrett_precompute(q) if (1 << 28) < q < (1 << 30) else 0

    return NTTParams(
        n=n, q=q, omega=omega, psi=psi,
        tw=tw.astype(np.uint32), twp=shoup_table(tw, q),
        itw=itw.astype(np.uint32), itwp=shoup_table(itw, q),
        ninv=ninv, ninv_p=(ninv << SHOUP_SHIFT) // q,
        psi_pows=psi_pows.astype(np.uint32), psi_pows_p=shoup_table(psi_pows, q),
        ipsi_ninv=ipsi_ninv.astype(np.uint32),
        ipsi_ninv_p=shoup_table(ipsi_ninv, q),
        barrett_mu=mu, mont_qinv_neg=qinv_neg, mont_r2=r2,
    )
