"""Plain modular arithmetic and number-theoretic transforms for the
benchmark's references.  torch and numpy only: no kernel, no table, no
code of the program under test.

Every residue is an int64 tensor holding a value in [0, q).  Products of
two residues below 2^30 stay below 2^60, so ``Arith`` multiplies exactly
in int64; ``Arith(exact=False)`` multiplies in float64 instead (53-bit
mantissa), the lower precision the controls run in.

The transforms are the textbook iterative radix-2 Cooley-Tukey network
over a bit-reversed input, so the cyclic pass comes out in natural
frequency order: X[k] = sum_j x[j] omega^(j k) mod q.
"""
from __future__ import annotations

import torch

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin (exact below 3.3e24)."""
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


def primes_below(bits: int, step: int, count: int) -> list[int]:
    """The ``count`` largest primes p < 2^bits with p = 1 (mod step), in
    descending order."""
    p = ((1 << bits) - 1) // step * step + 1
    out: list[int] = []
    while len(out) < count:
        if p <= (1 << (bits - 1)):
            raise ValueError(f"fewer than {count} {bits}-bit primes = 1 mod {step}")
        if is_prime(p):
            out.append(p)
        p -= step
    return out


def primitive_root(q: int) -> int:
    """The smallest generator of the multiplicative group mod prime q."""
    phi, fs, m, d = q - 1, [], q - 1, 2
    while d * d <= m:
        if m % d == 0:
            fs.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fs.append(m)
    return next(g for g in range(2, q) if all(pow(g, phi // f, q) != 1 for f in fs))


def root(q: int, order: int) -> int:
    """The frozen root rule: g^((q-1)/order) for g the smallest primitive
    root of q, a primitive ``order``-th root of unity."""
    if (q - 1) % order:
        raise ValueError(f"q={q} has no root of order {order}")
    return pow(primitive_root(q), (q - 1) // order, q)


def bitrev(n: int) -> list[int]:
    s = n.bit_length() - 1
    return [int(format(i, f"0{s}b")[::-1], 2) if s else 0 for i in range(n)]


def powers(base: int, count: int, q: int, start: int = 1) -> list[int]:
    out, v = [], start % q
    for _ in range(count):
        out.append(v)
        v = v * base % q
    return out


class Arith:
    """Modular multiply in int64 (exact) or float64 (the control)."""

    def __init__(self, exact: bool = True):
        self.exact = exact

    def mul(self, a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        if self.exact:
            return a * b % q
        p = torch.fmod(a.double() * b.double(), q.double())
        return p.round().long() % q


EXACT = Arith()


class Ring:
    """The negacyclic ring Z_q[X]/(X^n + 1) for each prime of a basis, on
    one device.  Tensors are (k, ..., n), prime axis first.

    ``ntt`` evaluates a coefficient row at psi^(1 + 2 ord(s)) into slot s,
    psi = root(q, 2n); ``ord`` is the identity (``natural``) or the
    bit-reversal of s.  That is the layout of the program's NTT words."""

    def __init__(self, primes, n: int, device, natural: bool, arith: Arith = EXACT):
        self.primes = tuple(int(q) for q in primes)
        self.n = n
        self.device = torch.device(device)
        self.arith = arith
        k = len(self.primes)
        psis = [root(q, 2 * n) for q in self.primes]
        omegas = [p * p % q for p, q in zip(psis, self.primes)]
        t = lambda rows: torch.tensor(rows, dtype=torch.int64, device=self.device)
        self.q = t(self.primes).reshape(k, 1)
        self.psi = t([powers(p, n, q) for p, q in zip(psis, self.primes)])
        self.ipsi_ninv = t([powers(pow(p, -1, q), n, q, start=pow(n, -1, q))
                            for p, q in zip(psis, self.primes)])
        # stage m (half-width) twiddles omega^(j n / 2m), j < m, both ways
        self.fwd, self.inv = [], []
        m = 1
        while m < n:
            self.fwd.append(t([powers(pow(w, n // (2 * m), q), m, q)
                               for w, q in zip(omegas, self.primes)]))
            self.inv.append(t([powers(pow(w, -(n // (2 * m)), q), m, q)
                               for w, q in zip(omegas, self.primes)]))
            m *= 2
        self.br = torch.tensor(bitrev(n), device=self.device)
        self.slot = None if natural else self.br

    def qcol(self, ndim: int) -> torch.Tensor:
        return self.q.reshape((-1,) + (1,) * (ndim - 1))

    def _cyclic(self, x: torch.Tensor, tables) -> torch.Tensor:
        k, n = x.shape[0], self.n
        lead = x.shape[1:-1]
        x = x[..., self.br].reshape(k, -1, n)
        q = self.q.reshape(k, 1, 1, 1)
        m = 1
        for w in tables:
            x = x.reshape(k, x.shape[1], n // (2 * m), 2 * m)
            u, v = x[..., :m], self.arith.mul(x[..., m:], w[:, None, None, :], q)
            x = torch.cat(((u + v) % q, (u - v) % q), dim=-1)
            m *= 2
        return x.reshape(k, *lead, n)

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients (k, ..., n) in [0, q) -> NTT words in slot order."""
        q = self.qcol(coeffs.ndim)
        psi = self.psi.reshape((coeffs.shape[0],) + (1,) * (coeffs.ndim - 2) + (self.n,))
        out = self._cyclic(self.arith.mul(coeffs % q, psi, q), self.fwd)
        return out if self.slot is None else out[..., self.slot]

    def intt(self, words: torch.Tensor) -> torch.Tensor:
        """NTT words in slot order -> coefficients in [0, q)."""
        q = self.qcol(words.ndim)
        x = words % q
        x = x if self.slot is None else x[..., self.slot]   # bit reversal is an involution
        w = self.ipsi_ninv.reshape((words.shape[0],) + (1,) * (words.ndim - 2) + (self.n,))
        return self.arith.mul(self._cyclic(x, self.inv), w, q)


def centered(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Residues in [0, q) as integers in (-q/2, q/2]."""
    return torch.where(x > q // 2, x - q, x)

