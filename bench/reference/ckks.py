"""Plain CKKS-RNS reference for the Fig 22 key switch: keys, rotation,
conjugation, multiply with relinearization, rescale and the BSGS
plaintext matvec, worked out again from their inputs with textbook
modular arithmetic (``modring``).  torch and numpy only; nothing of the
program under test is imported or read.

Conventions frozen here, as the deployment states them:

* The basis: ``levels + 2`` primes p = 1 (mod 2n) below 2^30, the
  largest first; the largest is the special prime P of the key switch,
  the rest q_0 > q_1 > ... the ciphertext chain.  Rescaling drops the
  last prime of the chain.
* NTT words: slot s holds the evaluation at psi^(1 + 2 ord(s)) (``modring
  .Ring``), natural order from n = 2^13 up and bit-reversed below.
* Key switching with one prime per digit (dnum = number of primes): the
  digit i is the centred coefficient vector of the input mod q_i,
  extended exactly onto basis + P; the inner products with the key
  digits are reduced by P with a centred extension of their P row and a
  multiply by P^-1 (the same floor as the rescale).
* Key digit i of a switch from s' to s over basis Q:
  (e_i - a_i s + (P T_i mod p) s', a_i) at every prime p of Q + P, with
  T_i = (Q/q_i) ((Q/q_i)^-1 mod q_i).
* The secret, the public key and the keys come from one numpy
  ``default_rng(seed)``, drawn in this order: the ternary secret
  (``integers(-1, 2, n)``), the public key's uniform rows (one
  ``integers(0, q, n, dtype=uint32)`` per chain prime) and its Gaussian
  noise (``rint(normal(0, sigma, n))``); then, for each key in the order
  the deployment documents and for each prime q_i of its basis, digit
  i's uniform rows over basis + P and its Gaussian noise.
* Encoding (the matvec's diagonals): the canonical embedding at e_j =
  5^j mod 2n through ``numpy.fft.fft``, rounded with ``numpy.rint``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference.modring import EXACT, Arith, Ring, centered, primes_below


def chain(n: int, levels: int) -> tuple[int, tuple[int, ...]]:
    """(P, (q_0, ..., q_levels)) of the deployment."""
    primes = primes_below(30, 2 * n, levels + 2)
    return primes[0], tuple(primes[1:])


def galois_element(n: int, r: int | None) -> int:
    """The automorphism of a left rotation by r slots (5^r mod 2n), or of
    conjugation (r None: 2n - 1)."""
    return 2 * n - 1 if r is None else pow(5, r, 2 * n)


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """One switching key: ``g`` None for relinearization, else the
    Galois element; ``basis`` the chain primes it switches at."""
    g: int | None
    basis: tuple[int, ...]


class CkksReference:
    """The plain reference of one deployment on one device.

    ``key_order`` lists the ``KeySpec``s in the order they were drawn;
    only those in ``needed`` are worked out (every one is drawn, so the
    generator stays in step)."""

    def __init__(self, *, n: int, levels: int, seed: int, key_order, needed=None,
                 sigma: float = 3.2, device="cpu", arith: Arith = EXACT):
        self.n = n
        self.slots = n // 2
        self.device = torch.device(device)
        self.arith = arith
        self.natural = n >= 1 << 13
        self.P, self.qs = chain(n, levels)
        self._rings: dict = {}
        rng = np.random.default_rng(seed)
        self.s = rng.integers(-1, 2, size=n).astype(np.int64)
        for q in self.qs:                      # the public key's uniform rows
            rng.integers(0, q, size=n, dtype=np.uint32)
        rng.normal(0.0, sigma, size=n)         # and its noise
        needed = set(key_order if needed is None else needed)
        self.keys: dict = {}
        for spec in key_order:
            full = spec.basis + (self.P,)
            draws = []
            for _ in spec.basis:
                a = np.stack([rng.integers(0, p, size=n, dtype=np.uint32) for p in full])
                e = np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)
                draws.append((a, e))
            if spec in needed:
                self.keys[spec] = self._key(spec, draws)

    # ------------------------------------------------------------ rings

    def ring(self, primes) -> Ring:
        primes = tuple(primes)
        if primes not in self._rings:
            self._rings[primes] = Ring(primes, self.n, self.device, self.natural, self.arith)
        return self._rings[primes]

    def _from_ints(self, coeffs: np.ndarray, primes) -> torch.Tensor:
        """Integer coefficients (n,) -> NTT words over ``primes``."""
        c = torch.as_tensor(np.asarray(coeffs, dtype=np.int64), device=self.device)
        r = self.ring(primes)
        return r.ntt(c[None].expand(len(primes), -1) % r.qcol(2))

    # ------------------------------------------------------------- keys

    def _key(self, spec: KeySpec, draws):
        full = spec.basis + (self.P,)
        r = self.ring(full)
        q = r.qcol(2)
        s = self._from_ints(self.s, full)
        if spec.g is None:
            target = self.arith.mul(s, s, q)
        else:
            target = self._from_ints(automorphism_ints(self.s, spec.g, self.n), full)
        Q = math.prod(spec.basis)
        B, A = [], []
        for qi, (a_np, e_np) in zip(spec.basis, draws):
            Qi = Q // qi
            PT = self.P * (Qi * pow(Qi % qi, -1, qi) % Q)
            a = torch.as_tensor(a_np.astype(np.int64), device=self.device)
            e = self._from_ints(e_np, full)
            gadget = torch.tensor([PT % p for p in full], dtype=torch.int64,
                                  device=self.device)[:, None]
            b = (e - self.arith.mul(a, s, q) + self.arith.mul(gadget, target, q)) % q
            B.append(b)
            A.append(a)
        return torch.stack(B), torch.stack(A)          # (k digits, k + 1, n)

    # ---------------------------------------------------- key switching

    def mod_down(self, acc: torch.Tensor, primes) -> torch.Tensor:
        """Floor by the last prime of ``primes``: acc (k + 1, ..., n) NTT
        words -> (k, ..., n) over the first k."""
        primes = tuple(primes)
        last, rest = self.ring(primes[-1:]), self.ring(primes[:-1])
        top = centered(last.intt(acc[-1:]), last.qcol(acc.ndim))[0]
        q = rest.qcol(acc.ndim)
        ext = rest.ntt(top.unsqueeze(0) % q)
        d = (acc[:-1] - ext) % q
        pinv = torch.tensor([pow(primes[-1], -1, p) for p in primes[:-1]],
                            dtype=torch.int64, device=self.device)
        return self.arith.mul(d, pinv.reshape(q.shape), q)

    def key_switch(self, d: torch.Tensor, spec: KeySpec) -> tuple[torch.Tensor, torch.Tensor]:
        """d (k, ..., n) NTT words over ``spec.basis`` -> (ks0, ks1)."""
        basis, full = spec.basis, spec.basis + (self.P,)
        B, A = self.keys[spec]
        rq, rf = self.ring(basis), self.ring(full)
        digits = centered(rq.intt(d), rq.qcol(d.ndim))          # (k, ..., n)
        qf = rf.qcol(d.ndim + 1)
        ext = rf.ntt(digits.unsqueeze(0) % qf)                  # (k + 1 primes, k digits, ..., n)
        shape = (B.shape[1], B.shape[0]) + (1,) * (d.ndim - 2) + (self.n,)
        outs = []
        for key in (B, A):
            k = key.transpose(0, 1).reshape(shape)
            acc = self.arith.mul(ext, k, qf).sum(1) % rf.qcol(d.ndim)
            outs.append(self.mod_down(acc, full))
        return outs[0], outs[1]

    # ------------------------------------------------------------- ops

    def automorphism(self, words: torch.Tensor, g: int, primes) -> torch.Tensor:
        """sigma_g of NTT words over ``primes``, through the coefficient
        domain: X^t -> X^(g t mod 2n), folded by X^n = -1."""
        r = self.ring(primes)
        q = r.qcol(words.ndim)
        c = r.intt(words)
        t = torch.arange(self.n, device=self.device)
        dest = g * t % (2 * self.n)
        out = torch.empty_like(c)
        out[..., dest % self.n] = torch.where(dest >= self.n, (q - c) % q, c)
        return r.ntt(out)

    def rotate(self, c0, c1, basis, g):
        """Apply sigma_g to a ciphertext and switch back to s."""
        if g == 1:
            return c0, c1
        c0g = self.automorphism(c0, g, basis)
        c1g = self.automorphism(c1, g, basis)
        ks0, ks1 = self.key_switch(c1g, KeySpec(g, tuple(basis)))
        return (c0g + ks0) % self.ring(basis).qcol(c0.ndim), ks1

    def multiply(self, a0, a1, b0, b1, basis):
        q = self.ring(basis).qcol(a0.ndim)
        m = lambda x, y: self.arith.mul(x, y, q)
        d0, d1, d2 = m(a0, b0), (m(a0, b1) + m(a1, b0)) % q, m(a1, b1)
        ks0, ks1 = self.key_switch(d2, KeySpec(None, tuple(basis)))
        return (d0 + ks0) % q, (d1 + ks1) % q

    def rescale(self, c0, c1, basis):
        return self.mod_down(c0, basis), self.mod_down(c1, basis)

    # ----------------------------------------------------------- matvec

    def encode(self, z, scale: float, basis) -> torch.Tensor:
        """Complex slots -> plaintext NTT words over ``basis``."""
        n2 = 2 * self.n
        ejs = np.array([pow(5, j, n2) for j in range(self.slots)])
        zz = np.zeros(self.slots, dtype=np.complex128)
        zz[: len(z)] = z
        spec = np.zeros(n2, dtype=np.complex128)
        spec[ejs] = zz
        spec[n2 - ejs] = np.conj(zz)
        c = np.fft.fft(spec)[: self.n].real / self.n
        return self._from_ints(np.rint(c * scale).astype(np.int64), basis)

    def matvec(self, W: np.ndarray, scale: float, c0, c1, basis):
        """y = x @ W on the tiled slot layout, by baby-step/giant-step
        diagonals: n1 = ceil(sqrt(d_in)) baby rotations of the input, one
        plaintext product sum per giant step, the giant rotations of the
        partial sums, and their sum.  c0, c1 (k, ..., n): a stack of
        ciphertexts, each multiplied by the same W."""
        d_in, d_out = W.shape
        n1 = math.isqrt(d_in - 1) + 1 if d_in > 1 else 1
        q = self.ring(basis).qcol(c0.ndim)
        m = np.arange(d_out)
        diags = {}
        for r in range(d_in):
            diag = np.zeros(self.slots, dtype=np.complex128)
            diag[m] = W[(m + r) % d_in, m]
            if np.any(diag):
                i, j = divmod(r, n1)
                pt = self.encode(np.roll(diag, i * n1), scale, basis)
                diags[(i, j)] = pt.reshape(pt.shape[0], *([1] * (c0.ndim - 2)), self.n)
        babies = {j: self.rotate(c0, c1, basis, galois_element(self.n, j))
                  for j in sorted({j for _, j in diags})}
        inner: dict = {}
        for (i, j), pt in sorted(diags.items()):
            b0, b1 = babies[j]
            s0, s1 = inner.get(i, (0, 0))
            inner[i] = ((s0 + self.arith.mul(pt, b0, q)) % q,
                        (s1 + self.arith.mul(pt, b1, q)) % q)
        out0, out1 = 0, 0
        for i, (s0, s1) in sorted(inner.items()):
            p0, p1 = self.rotate(s0, s1, basis, galois_element(self.n, i * n1))
            out0, out1 = (out0 + p0) % q, (out1 + p1) % q
        return out0, out1


def automorphism_ints(coeffs: np.ndarray, g: int, n: int) -> np.ndarray:
    """sigma_g on an integer coefficient vector (scatter form)."""
    t = np.arange(n)
    dest = g * t % (2 * n)
    out = np.empty(n, dtype=np.int64)
    out[dest % n] = np.where(dest >= n, -coeffs, coeffs)
    return out


def matvec_key_amounts(d_in: int, W: np.ndarray | None = None) -> list[int]:
    """The rotation amounts a BSGS matvec of a d_in-row matrix uses: its
    baby steps 1 .. n1 - 1 and its giant steps i n1 (only those of
    nonzero diagonals when W is given)."""
    n1 = math.isqrt(d_in - 1) + 1 if d_in > 1 else 1
    rs = range(d_in) if W is None else [r for r in range(d_in)
                                        if np.any(W[(np.arange(W.shape[1]) + r) % d_in,
                                                    np.arange(W.shape[1])])]
    amounts = set()
    for r in rs:
        i, j = divmod(r, n1)
        amounts.update((j, i * n1))
    return sorted(a for a in amounts if a)
