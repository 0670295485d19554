"""CKKS-RNS scheme on the port's banks kernels (paper §II, §VIII).

Host/device split as in the paper's Fig 1: key generation, encoding
(canonical embedding) and CRT decode run on the host; every ciphertext
ring op — NTT, iNTT, dyadic multiply/add, key switch, RNS floor — runs
on the context's device.  The numpy random draws come in exactly the
reference's order, so with the same seed keys and ciphertexts are the
same integers.  Under hybrid key switching (``dnum`` below L + 1) the
draws keep that order, one key digit per run of alpha primes.

Supported here: encode/decode, public-key encryption, decryption,
add/sub, plaintext add/multiply, multiply with relinearization, rescale, slot rotation and
conjugation through Galois automorphisms, and the batched
``multiply_many`` / ``rescale_many`` / ``rotate_many`` /
``conjugate_many`` and hoisted ``rotate_hoisted``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core.modmath import submod
from repro_torch.core.params import galois_coeff_tables
from repro_torch.fhe import batched as FB
from repro_torch.fhe import rns
from repro_torch.fhe.evalplan import Ciphertext, EvalPlan, check_same_basis
from repro_torch.fhe.rns import RnsPoly

__all__ = ["Ciphertext", "CkksContext", "galois_int_coeffs", "galois_poly",
           "resolve_device"]


class CkksContext:
    """One CKKS deployment: its ring, prime chain, secret and keys.

    ``dnum`` is the number of key-switch digits at the full chain.  The
    default (``None``, or ``levels + 1``) is one prime per digit and one
    special prime P, the paper's Fig 22 key switch.  A smaller ``dnum``
    is hybrid key switching (Han & Ki, CT-RSA 2020): digits of alpha =
    ceil((L + 1) / dnum) consecutive chain primes (the last digit of a
    basis may hold fewer) and a special modulus P of K = alpha primes.

    The primes are the L + 1 + K largest below 2^30 that are 1 mod 2n,
    largest first: the first K are P's (``specials``), the rest q_0 >
    ... > q_L (``qs``).  ``special`` is the one special prime when K = 1
    and None otherwise."""

    def __init__(self, n: int = 1024, levels: int = 3, scale_bits: int = 28,
                 sigma: float = 3.2, seed: int = 0, device=None, dnum: int | None = None):
        self.device = resolve_device(device)
        self.n = n
        self.slots = n // 2
        self.scale = float(1 << scale_bits)
        self.sigma = sigma
        chain = levels + 1
        self.dnum = chain if dnum is None else dnum
        if not 1 <= self.dnum <= chain:
            raise ValueError(f"CkksContext: dnum = {dnum} key-switch digits for a chain of "
                             f"{chain} primes; 1 <= dnum <= levels + 1")
        self.alpha = -(-chain // self.dnum)               # primes a digit
        K = self.alpha                                    # special primes
        primes = rns.make_primes(n, chain + K)            # P's K, then the chain
        self.specials = tuple(primes[:K])                 # the largest -> P
        self.special = primes[0] if K == 1 else None
        self.qs = tuple(primes[K:])                       # q_0 .. q_L
        self.rng = np.random.default_rng(seed)
        # canonical embedding index table: e_j = 5^j mod 2n
        self._ejs = np.array([pow(5, j, 2 * n) for j in range(n // 2)])
        # secret key (ternary), kept host-side
        self._s_coeffs = rns.ternary_coeffs(self.rng, n)
        full = self.qs
        a = rns.uniform_ntt(self.rng, full, n, self.device)
        e = self._noise_poly(full)
        s = self._secret_poly(full)
        self.pk = (e.sub(a.mul(s)), a)                    # (b, a) = (-as + e, a)
        self._relin: dict = {}
        self._galois: dict = {}
        self._plan: EvalPlan | None = None

    def plan(self) -> EvalPlan:
        """The device-resident evaluation plan (built lazily, cached)."""
        if self._plan is None:
            self._plan = EvalPlan(self)
        return self._plan

    # ------------------------------------------------------------ keys

    def _secret_poly(self, primes, coeffs=None) -> RnsPoly:
        c = self._s_coeffs if coeffs is None else coeffs
        return rns.from_int_coeffs(c, tuple(primes), self.n, self.device).to_ntt()

    def _noise_poly(self, primes) -> RnsPoly:
        return rns.from_int_coeffs(rns.gaussian_coeffs(self.rng, self.n, self.sigma),
                                   tuple(primes), self.n, self.device).to_ntt()

    def digits(self, primes: tuple[int, ...]) -> list[tuple[int, ...]]:
        """The key-switch digits of a basis: runs of ``alpha`` primes
        q_i, j alpha <= i < min((j + 1) alpha, l + 1)."""
        return FB.key_digits(primes, self.alpha)

    def _make_ksk(self, from_key: RnsPoly, primes: tuple[int, ...]):
        """Digit keys: evk_j = (-a_j s + e_j + P*T_j*from_key, a_j) over
        basis (primes..., P's primes), for each digit D_j of Q_j = prod
        D_j, with P the product of the special primes and T_j = Q^_j
        [Q^_j^-1]_{Q_j}, Q^_j = Q / Q_j (one prime per digit: the CRT
        interpolation coefficient).  Each digit draws its uniform rows
        over the full basis, then its Gaussian noise."""
        full = primes + self.specials
        s_full = self._secret_poly(full)
        Q = math.prod(primes)
        P = math.prod(self.specials)
        evk = []
        for D in self.digits(primes):
            Qj = math.prod(D)
            hat = Q // Qj
            PTj = P * (hat * pow(hat % Qj, -1, Qj) % Q)
            a = rns.uniform_ntt(self.rng, full, self.n, self.device)
            e = self._noise_poly(full)
            b = e.sub(a.mul(s_full))
            gadget = from_key.mul_scalar_per_prime({q: PTj % q for q in full})
            evk.append((b.add(gadget), a))
        return evk

    def relin_keys(self, primes: tuple[int, ...]):
        """Relinearization key digits for a basis (generated once)."""
        if primes not in self._relin:
            s = self._secret_poly(primes + self.specials)
            self._relin[primes] = self._make_ksk(s.mul(s), primes)
        return self._relin[primes]

    def galois_keys(self, g: int, primes: tuple[int, ...]):
        """Key-switch digits from sigma_g(s) to s for a basis, drawn from
        the context's generator once per (g, basis)."""
        if (g, primes) not in self._galois:
            full = primes + self.specials
            sg = self._secret_poly(
                full, coeffs=galois_int_coeffs(self._s_coeffs, g, self.n))
            self._galois[(g, primes)] = self._make_ksk(sg, primes)
        return self._galois[(g, primes)]

    # -------------------------------------------------- encode / decode

    def encode(self, z, scale: float | None = None,
               basis: tuple[int, ...] | None = None) -> RnsPoly:
        """z: complex array of up to n/2 slots -> plaintext RnsPoly (NTT)."""
        scale = scale or self.scale
        basis = tuple(basis if basis is not None else self.qs)
        z = np.asarray(z, dtype=np.complex128)
        zz = np.zeros(self.slots, dtype=np.complex128)
        zz[: len(z)] = z
        n2 = 2 * self.n
        spec = np.zeros(n2, dtype=np.complex128)
        spec[self._ejs] = zz
        spec[n2 - self._ejs] = np.conj(zz)
        c = np.fft.fft(spec)[: self.n].real / self.n
        c_int = np.rint(c * scale).astype(np.int64).astype(object)
        return rns.from_int_coeffs(c_int, basis, self.n, self.device).to_ntt()

    def _decode_coeffs(self, coeffs_float: np.ndarray) -> np.ndarray:
        n2 = 2 * self.n
        padded = np.zeros(n2, dtype=np.complex128)
        padded[: self.n] = coeffs_float
        F = np.fft.ifft(padded) * n2
        return F[self._ejs]

    def decode(self, pt: RnsPoly, scale: float) -> np.ndarray:
        big = rns.crt_reconstruct_centered(pt if not pt.is_ntt else pt.to_coeff())
        return self._decode_coeffs(rns.centered_to_float(big, scale))

    # ------------------------------------------------ encrypt / decrypt

    def encrypt(self, pt: RnsPoly, scale: float | None = None) -> Ciphertext:
        scale = scale or self.scale
        primes = pt.primes
        v = rns.from_int_coeffs(rns.ternary_coeffs(self.rng, self.n), primes,
                                self.n, self.device).to_ntt()
        e0 = self._noise_poly(primes)
        e1 = self._noise_poly(primes)
        b, a = self.pk
        c0 = b.mul(v).add(e0).add(pt)
        c1 = a.mul(v).add(e1)
        return Ciphertext(c0, c1, scale)

    def decrypt(self, ct: Ciphertext) -> RnsPoly:
        s = self._secret_poly(ct.primes)
        return ct.c0.add(ct.c1.mul(s))

    def decrypt_decode(self, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt(ct), ct.scale)

    # --------------------------------------------------------- homomorphic

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_same_basis("add", a, b, check_scale=True)
        return Ciphertext(a.c0.add(b.c0), a.c1.add(b.c1), a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_same_basis("sub", a, b, check_scale=True)
        return Ciphertext(a.c0.sub(b.c0), a.c1.sub(b.c1), a.scale)

    def add_plain(self, a: Ciphertext, pt: RnsPoly) -> Ciphertext:
        return Ciphertext(a.c0.add(pt), a.c1, a.scale)

    def mul_plain(self, a: Ciphertext, pt: RnsPoly,
                  pt_scale: float | None = None) -> Ciphertext:
        pt_scale = pt_scale or self.scale
        return Ciphertext(a.c0.mul(pt), a.c1.mul(pt), a.scale * pt_scale)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor + relinearize (paper Table I 'Homomorphic Mult')."""
        return self.plan().multiply(a, b)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """RNS floor by q_l, both halves through one ``mod_down_banks``."""
        return self.plan().rescale(a)

    def multiply_many(self, As, Bs) -> list[Ciphertext]:
        """B independent products at one basis in one pass of every
        kernel; bit-identical to a loop of ``multiply``."""
        return self.plan().multiply_many(As, Bs)

    def rescale_many(self, cts) -> list[Ciphertext]:
        return self.plan().rescale_many(cts)

    def rotate(self, a: Ciphertext, r: int) -> Ciphertext:
        """Rotate slots left by r (Galois automorphism X -> X^(5^r)), as an
        NTT-domain gather and one key switch."""
        return self.plan().rotate(a, r)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.plan().conjugate(a)

    def rotate_many(self, cts, rs) -> list[Ciphertext]:
        """Rotate B ciphertexts by per-ciphertext amounts in one pass of
        every kernel; the batch may mix amounts."""
        return self.plan().rotate_many(cts, rs)

    def conjugate_many(self, cts) -> list[Ciphertext]:
        return self.plan().conjugate_many(cts)

    def rotate_hoisted(self, a: Ciphertext, rs) -> list[Ciphertext]:
        """R rotations of one ciphertext with the key-switch digit
        decomposition paid once; bit-identical to
        ``[self.rotate(a, r) for r in rs]`` with one prime a digit (under
        hybrid key switching the hoisted key switch's words, which
        decrypt to the same rotations)."""
        return self.plan().rotate_hoisted(a, rs)


# ------------------------------------------------- Galois automorphism
#
# Coefficient-domain forms: keygen applies galois_int_coeffs to the
# ternary secret, and galois_poly is the oracle the NTT-domain gather is
# held against.  No request runs them.

def galois_int_coeffs(coeffs: np.ndarray, g: int, n: int) -> np.ndarray:
    """sigma_g on integer coefficient vectors: X^t -> X^(g t mod 2n) with
    X^n = -1 folding, as one gather and sign flip."""
    src, pos = galois_coeff_tables(g, n)
    c = np.asarray(coeffs)
    return np.where(pos, c[src], -c[src])


def galois_poly(p: RnsPoly, g: int) -> RnsPoly:
    """sigma_g applied per residue row in the coefficient domain (one
    gather and a modular negate over the stack), back in NTT form if the
    input was."""
    was_ntt = p.is_ntt
    if was_ntt:
        p = p.to_coeff()
    src, pos = galois_coeff_tables(g, p.n)
    rows = p.data[:, torch.from_numpy(src).to(p.device)].long()
    neg = submod(torch.zeros_like(rows), rows, p._q)
    keep = torch.from_numpy(pos).to(p.device)
    res = RnsPoly(torch.where(keep, rows, neg).int(), p.primes, False)
    return res.to_ntt() if was_ntt else res
