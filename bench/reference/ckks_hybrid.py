"""Plain CKKS-RNS reference under hybrid key switching (Han & Ki, CT-RSA
2020): keys, rotation, conjugation, multiply with relinearization and
rescale, worked out again from their inputs with textbook modular
arithmetic (``modring``).  torch and numpy only; nothing of the program
under test is imported or read.

Conventions frozen here (those of ``reference.ckks`` but for the key
switch):

* dnum digits at the full chain of L + 1 primes: alpha = ceil((L + 1) /
  dnum) primes a digit, and a special modulus P of K = alpha primes.
* The basis: the L + 1 + K largest primes p = 1 (mod 2n) below 2^30,
  largest first; the first K are P's primes P_0 > ... > P_{K-1}, the rest
  the ciphertext chain q_0 > ... > q_L.  Rescaling drops the last prime
  of the chain and keeps one prime (K = 1): the centred floor of
  ``reference.ckks``.
* Digit j of a basis q_0 .. q_l holds the primes q_i with j alpha <= i <
  min((j + 1) alpha, l + 1): the last digit may hold fewer.
* Mod-up of digit j (primes D_j, product Q_j) from the coefficient
  residues x_q, q in D_j, onto each prime p of basis + P outside D_j, the
  unsigned fast base conversion (Cheon, Han, Kim, Kim & Song, SAC 2018):
      Conv(x)_p = sum_{q in D_j} [x_q (Q_j/q)^-1]_q (Q_j/q mod p)  mod p;
  on the digit's own primes x is unchanged.
* Mod-down of acc over basis + P: (acc_Q - Conv_{P->Q}(acc_P)) [P^-1]_{q}
  at each chain prime q, Conv_{P->Q} the same formula over P's primes
  applied to the iNTT of acc's P rows, then the NTT.
* Key digit j of a switch from s' to s over basis Q (product of the
  basis): (e_j - a_j s + (P T_j mod p) s', a_j) at every prime p of the
  basis + P, with T_j = Q^_j [Q^_j^-1]_{Q_j}, Q^_j = Q / Q_j.
* The secret, the public key and the keys come from one numpy
  ``default_rng(seed)``, drawn in this order: the ternary secret
  (``integers(-1, 2, n)``), the public key's uniform rows (one
  ``integers(0, q, n, dtype=uint32)`` per chain prime) and its Gaussian
  noise (``rint(normal(0, sigma, n))``); then, for each key in the order
  the caller lists them and for each of its digits, the digit's
  uniform rows over basis + P (one row per prime, in that order) and its
  Gaussian noise.
* Hoisted rotations of one ciphertext convert its c1 once and apply
  each automorphism to the converted digits (``rotate_hoisted``).
* NTT words, the automorphisms and the encoding as in ``reference.ckks``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.ckks import CkksReference, KeySpec, automorphism_ints
from reference.modring import EXACT, Arith, primes_below


def hybrid_chain(n: int, levels: int, dnum: int):
    """(alpha, (P_0, ..., P_{K-1}), (q_0, ..., q_L)) of the deployment."""
    if not 1 <= dnum <= levels + 1:
        raise ValueError(f"dnum {dnum} for {levels + 1} chain primes")
    alpha = -(-(levels + 1) // dnum)
    primes = primes_below(30, 2 * n, levels + 1 + alpha)
    return alpha, tuple(primes[:alpha]), tuple(primes[alpha:])


def digits(basis, alpha: int) -> list[tuple[int, ...]]:
    basis = tuple(basis)
    return [basis[i:i + alpha] for i in range(0, len(basis), alpha)]


class HybridReference(CkksReference):
    """The plain reference of one hybrid deployment on one device.

    ``key_order`` lists the ``KeySpec``s in the order they were drawn;
    only those in ``needed`` are worked out (every one is drawn, so the
    generator stays in step)."""

    def __init__(self, *, n: int, levels: int, dnum: int, seed: int, key_order,
                 needed=None, sigma: float = 3.2, device="cpu", arith: Arith = EXACT):
        self.n = n
        self.slots = n // 2
        self.device = torch.device(device)
        self.arith = arith
        self.natural = n >= 1 << 13
        self.alpha, self.Ps, self.qs = hybrid_chain(n, levels, dnum)
        self._rings: dict = {}
        rng = np.random.default_rng(seed)
        self.s = rng.integers(-1, 2, size=n).astype(np.int64)
        for q in self.qs:                      # the public key's uniform rows
            rng.integers(0, q, size=n, dtype=np.uint32)
        rng.normal(0.0, sigma, size=n)         # and its noise
        needed = set(key_order if needed is None else needed)
        self.keys: dict = {}
        for spec in key_order:
            full = spec.basis + self.Ps
            draws = []
            for _ in digits(spec.basis, self.alpha):
                a = np.stack([rng.integers(0, p, size=n, dtype=np.uint32) for p in full])
                e = np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)
                draws.append((a, e))
            if spec in needed:
                self.keys[spec] = self._key(spec, draws)

    # ------------------------------------------------------------- keys

    def _key(self, spec: KeySpec, draws):
        full = spec.basis + self.Ps
        r = self.ring(full)
        q = r.qcol(2)
        s = self._from_ints(self.s, full)
        if spec.g is None:
            target = self.arith.mul(s, s, q)
        else:
            target = self._from_ints(automorphism_ints(self.s, spec.g, self.n), full)
        Q, P = math.prod(spec.basis), math.prod(self.Ps)
        B, A = [], []
        for D, (a_np, e_np) in zip(digits(spec.basis, self.alpha), draws):
            Qj = math.prod(D)
            hat = Q // Qj
            PT = P * (hat * pow(hat % Qj, -1, Qj) % Q)
            a = torch.as_tensor(a_np.astype(np.int64), device=self.device)
            e = self._from_ints(e_np, full)
            gadget = torch.tensor([PT % p for p in full], dtype=torch.int64,
                                  device=self.device)[:, None]
            b = (e - self.arith.mul(a, s, q) + self.arith.mul(gadget, target, q)) % q
            B.append(b)
            A.append(a)
        return torch.stack(B), torch.stack(A)          # (digits, l + 1 + K, n)

    # ---------------------------------------------------- key switching

    def conv(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        """The fast base conversion of the residues x (len(src), ..., n),
        coefficient form, from the primes ``src`` onto each prime of
        ``dst``: (len(dst), ..., n).  A prime of ``dst`` in ``src`` keeps
        its row."""
        src, dst = tuple(src), tuple(dst)
        Q = math.prod(src)
        col = lambda vals: torch.tensor(vals, dtype=torch.int64,
                                        device=self.device).reshape((-1,) + (1,) * (x.ndim - 1))
        y = self.arith.mul(x, col([pow(Q // q % q, -1, q) for q in src]), col(src))
        out = []
        for p in dst:
            if p in src:
                out.append(x[src.index(p)])
                continue
            acc = torch.zeros_like(x[0])
            pc = torch.tensor(p, dtype=torch.int64, device=self.device)
            for i, q in enumerate(src):
                acc = (acc + self.arith.mul(y[i], torch.tensor(Q // q % p, device=self.device),
                                            pc)) % p
            out.append(acc)
        return torch.stack(out)

    def mod_down_p(self, acc: torch.Tensor, basis) -> torch.Tensor:
        """acc (l + 1 + K, ..., n) NTT words over basis + P -> (l + 1, ...,
        n) over the basis: the floor by P."""
        basis = tuple(basis)
        k = len(basis)
        rq, rp = self.ring(basis), self.ring(self.Ps)
        q = rq.qcol(acc.ndim)
        ext = rq.ntt(self.conv(rp.intt(acc[k:]), self.Ps, basis))
        d = (acc[:k] - ext) % q
        P = math.prod(self.Ps)
        pinv = torch.tensor([pow(P, -1, p) for p in basis], dtype=torch.int64,
                            device=self.device)
        return self.arith.mul(d, pinv.reshape(q.shape), q)

    def mod_up(self, d: torch.Tensor, basis) -> torch.Tensor:
        """d (l + 1, ..., n) NTT words over ``basis`` -> the NTT words of
        its digits converted onto basis + P: (l + 1 + K, digits, ..., n)."""
        basis = tuple(basis)
        full = basis + self.Ps
        x = self.ring(basis).intt(d)                            # (l + 1, ..., n)
        exts, lo = [], 0
        for D in digits(basis, self.alpha):
            exts.append(self.conv(x[lo:lo + len(D)], D, full))
            lo += len(D)
        return self.ring(full).ntt(torch.stack(exts, dim=1))

    def switch(self, ext: torch.Tensor, spec: KeySpec) -> tuple[torch.Tensor, torch.Tensor]:
        """The digit inner products of ``mod_up``'s words with the key of
        ``spec``, each floored by P: (ks0, ks1) over the basis."""
        basis = tuple(spec.basis)
        B, A = self.keys[spec]
        rf = self.ring(basis + self.Ps)
        qf = rf.qcol(ext.ndim)
        shape = (B.shape[1], B.shape[0]) + (1,) * (ext.ndim - 3) + (self.n,)
        outs = []
        for key in (B, A):
            kk = key.transpose(0, 1).reshape(shape)
            acc = self.arith.mul(ext, kk, qf).sum(1) % rf.qcol(ext.ndim - 1)
            outs.append(self.mod_down_p(acc, basis))
        return outs[0], outs[1]

    def key_switch(self, d: torch.Tensor, spec: KeySpec) -> tuple[torch.Tensor, torch.Tensor]:
        """d (l + 1, ..., n) NTT words over ``spec.basis`` -> (ks0, ks1)."""
        return self.switch(self.mod_up(d, spec.basis), spec)

    def rotate_hoisted(self, c0, c1, basis, gs):
        """Hoisted rotations of one ciphertext: c1's mod-up once, then for
        each g sigma_g of its converted digits (in the NTT words over
        basis + P), the switch under g's key, and sigma_g(c0) added.
        The unsigned conversion does not commute with the automorphism's
        sign flips, so these words differ from ``rotate``'s by key-switch
        noise; both decrypt to the rotation."""
        basis = tuple(basis)
        full = basis + self.Ps
        ext = self.mod_up(c1, basis)
        q = self.ring(basis).qcol(c0.ndim)
        out = []
        for g in gs:
            if g == 1:
                out.append((c0, c1))
                continue
            ks0, ks1 = self.switch(self.automorphism(ext, g, full), KeySpec(g, basis))
            out.append(((self.automorphism(c0, g, basis) + ks0) % q, ks1))
        return out
