"""Device-resident CKKS evaluation plan for multiply and rescale
(paper Fig 1 / Fig 22).

An ``EvalPlan`` precomputes, per prime basis, the stacked tables the bank
kernels consume (TablePack for single-kernel rings, FourStepPack + scalar
pack past ``ops.FOURSTEP_MIN_N``) and the stacked ``(k, k+1, n)``
relinearization key digits, then runs each scheme op as one program over
raw (k, n) residue stacks:

  multiply   -> ``multiply_banks``  (tensor product + fused batched_keyswitch)
  rescale    -> ``rescale_banks``   (both halves through one mod_down_banks)

The ``*_many`` twins take (B, k, n) leading-batch stacks: B ciphertexts
at one basis ride one pass of every kernel, bit-identical to a loop of
the single-ciphertext programs.  Batching never crosses bases.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.modmath import addmod, mulmod_barrett, u32
from repro_torch.fhe import batched as FB
from repro_torch.fhe import rns
from repro_torch.fhe.batched import batched_keyswitch, mod_down_banks
from repro_torch.fhe.rns import RnsPoly
from repro_torch.kernels import ops


@dataclasses.dataclass
class Ciphertext:
    c0: RnsPoly
    c1: RnsPoly
    scale: float

    @property
    def primes(self):
        return self.c0.primes

    @property
    def level(self) -> int:
        return len(self.primes) - 1


# ------------------------------------------------------- scheme-API checks

def _ct_desc(ct: Ciphertext) -> str:
    return f"primes={ct.primes} (level {ct.level}, scale {ct.scale:g})"


def check_same_basis(op: str, a: Ciphertext, b: Ciphertext,
                     check_scale: bool = False):
    """Raise ``ValueError`` when two operands disagree on basis — or on
    scale, for ops like ``add`` that require it."""
    if a.primes != b.primes:
        raise ValueError(
            f"{op}: operand bases differ — lhs {_ct_desc(a)} vs rhs "
            f"{_ct_desc(b)}; rescale / level-align both operands first "
            "(mixed bases never combine or batch)")
    if check_scale and abs(a.scale - b.scale) > 1e-9 * abs(a.scale):
        raise ValueError(
            f"{op}: operand scales differ — lhs {_ct_desc(a)} vs rhs "
            f"{_ct_desc(b)}; rescale or scale-match the operands first")


def check_level(op: str, ct: Ciphertext, need: int = 0):
    """``rescale`` needs a modulus to drop (need=1); every op needs a
    non-empty basis."""
    if ct.level < need:
        raise ValueError(
            f"{op}: prime chain exhausted — ciphertext has "
            f"{len(ct.primes)} modulus(es) left ({_ct_desc(ct)}) but "
            f"{op} needs level >= {need}; build the CkksContext with "
            "more levels for deeper circuits")


# ------------------------------------------------------------ programs

def _tensor_product(a0, a1, b0, b1, q, mu):
    """(d0, d1, d2) = (a0*b0, a0*b1 + a1*b0, a1*b1) as int64 u32 values,
    for NTT-form halves broadcasting against the (.., k, 1) columns q/mu."""
    a0, a1, b0, b1 = a0.long(), a1.long(), b0.long(), b1.long()
    d0 = mulmod_barrett(a0, b0, q, mu)
    d1 = addmod(mulmod_barrett(a0, b1, q, mu), mulmod_barrett(a1, b0, q, mu), q)
    d2 = mulmod_barrett(a1, b1, q, mu)
    return d0, d1, d2


def multiply_banks(a0, a1, b0, b1, evk_b, evk_a, t, fsp=None):
    """Ciphertext tensor + relinearization.  a0/a1/b0/b1: (k, n) NTT-form
    halves; evk_b/evk_a: (k, k+1, n) relin key digits; t (+ fsp) the
    basis+special tables.  Returns the (c0, c1) stacks."""
    k = a0.shape[0]
    q = u32(t["qs"][:k])[:, None]
    mu = u32(t["mu"][:k])[:, None]
    d0, d1, d2 = _tensor_product(a0, a1, b0, b1, q, mu)
    ks0, ks1 = batched_keyswitch(d2.int()[:, None], evk_b, evk_a, t, fsp=fsp)
    return (addmod(d0, ks0[:, 0].long(), q).int(),
            addmod(d1, ks1[:, 0].long(), q).int())


def rescale_banks(c0, c1, t, fsp=None):
    """Rescale by the last basis prime: both halves ride one fused
    ``mod_down_banks`` as a batch of two.  t's basis is the ciphertext
    basis itself (its last prime is the one dropped)."""
    acc = torch.stack([c0, c1], dim=1)                 # (k+1, 2, n)
    out = mod_down_banks(acc, t, fsp=fsp)
    return out[:, 0], out[:, 1]


def multiply_many_banks(a0, a1, b0, b1, evk_b, evk_a, t, fsp=None):
    """B tensor products + relinearization in one pass of every kernel.
    a0/a1/b0/b1: (B, k, n); evk_b/evk_a: (k, k+1, n) shared by the batch.
    Returns (B, k, n) stacks."""
    k = a0.shape[1]
    q = u32(t["qs"][:k])[None, :, None]
    mu = u32(t["mu"][:k])[None, :, None]
    d0, d1, d2 = _tensor_product(a0, a1, b0, b1, q, mu)
    ks0, ks1 = batched_keyswitch(d2.int().transpose(0, 1).contiguous(),
                                 evk_b, evk_a, t, fsp=fsp)
    return (addmod(d0, ks0.transpose(0, 1).long(), q).int(),
            addmod(d1, ks1.transpose(0, 1).long(), q).int())


def rescale_many_banks(c0, c1, t, fsp=None):
    """Rescale B ciphertexts by the last basis prime: all 2B halves ride
    one fused ``mod_down_banks``.  c0/c1: (B, k+1, n)."""
    B, kp1, n = c0.shape
    acc = torch.stack([c0, c1], dim=1)                  # (B, 2, k+1, n)
    acc = acc.reshape(2 * B, kp1, n).transpose(0, 1)    # (k+1, 2B, n)
    out = mod_down_banks(acc, t, fsp=fsp)
    out = out.transpose(0, 1).reshape(B, 2, kp1 - 1, n)
    return out[:, 0], out[:, 1]


class EvalPlan:
    """Precomputed device tables + stacked keys for one CkksContext.

    ``stats`` counts, per plan:
      dispatches   scheme programs run
      key_switches key-switch inner products applied (the paper's Fig 22
                   op, the unit of its key-switch rate)
      decomposes   RNS digit decompositions paid
    """

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.n
        self.device = ctx.device
        self.natural = self.n >= ops.FOURSTEP_MIN_N
        self._keys: dict = {}
        self._rescale_tables: dict = {}
        self.reset_stats()

    def reset_stats(self):
        self.stats = {"dispatches": 0, "key_switches": 0, "decomposes": 0}
        return self

    def _count(self, dispatches=1, key_switches=0, decomposes=0):
        self.stats["dispatches"] += dispatches
        self.stats["key_switches"] += key_switches
        self.stats["decomposes"] += decomposes

    # ------------------------------------------------------------ tables

    def _packs(self, full: tuple[int, ...]):
        """(t, fsp) for a basis whose last prime is the special/dropped
        one; past the four-step threshold t is just the scalar columns."""
        if self.natural:
            return (rns.scalar_pack(full, self.device),
                    rns.fourstep_basis_pack(full, self.n, self.device))
        return rns.basis_pack(full, self.n, self.device), None

    def keyswitch_tables(self, basis: tuple[int, ...]):
        return self._packs(basis + (self.ctx.special,))

    def rescale_tables(self, basis: tuple[int, ...]):
        if basis not in self._rescale_tables:
            if self.natural:
                # the FourStepPack has no basis-relative rows, so rescale
                # shares a slice of the key-switch pack (basis + special)
                _, ks_fsp = self.keyswitch_tables(basis)
                self._rescale_tables[basis] = (
                    rns.scalar_pack(basis, self.device),
                    FB.slice_fourstep_pack(ks_fsp, slice(0, len(basis))))
            else:
                self._rescale_tables[basis] = self._packs(basis)
        return self._rescale_tables[basis]

    # -------------------------------------------------------------- keys

    def relin_key(self, basis: tuple[int, ...]):
        """(k, k+1, n) stacked relinearization key digit tensors."""
        key = ("relin", basis)
        if key not in self._keys:
            evk = self.ctx.relin_keys(basis)
            self._keys[key] = (torch.stack([p[0].data for p in evk]),
                               torch.stack([p[1].data for p in evk]))
        return self._keys[key]

    def prepare(self, basis: tuple[int, ...] | None = None):
        """Build the tables and the relinearization key of one basis up
        front, so no request pays keygen or table construction.  The
        counters are reset on exit."""
        basis = tuple(basis if basis is not None else self.ctx.qs)
        self.keyswitch_tables(basis)
        self.rescale_tables(basis)
        self.relin_key(basis)
        return self.reset_stats()

    # ------------------------------------------------------- scheme ops

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_same_basis("multiply", a, b)
        check_level("multiply", a)
        basis = a.primes
        t, fsp = self.keyswitch_tables(basis)
        eb, ea = self.relin_key(basis)
        c0, c1 = multiply_banks(a.c0.data, a.c1.data, b.c0.data, b.c1.data,
                                eb, ea, t, fsp)
        self._count(1, key_switches=1, decomposes=1)
        return Ciphertext(RnsPoly(c0, basis, True), RnsPoly(c1, basis, True),
                          a.scale * b.scale)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        check_level("rescale", a, need=1)
        basis = a.primes
        t, fsp = self.rescale_tables(basis)
        c0, c1 = rescale_banks(a.c0.data, a.c1.data, t, fsp)
        self._count(1)
        rest = basis[:-1]
        return Ciphertext(RnsPoly(c0, rest, True), RnsPoly(c1, rest, True),
                          a.scale / basis[-1])

    def _common_basis(self, op: str, cts) -> tuple[int, ...]:
        basis = cts[0].primes
        for ct in cts[1:]:
            if ct.primes != basis:
                raise ValueError(
                    f"{op}: batch mixes bases — {sorted({c.primes for c in cts}, key=len)}; "
                    "batched dispatch requires every ciphertext at the "
                    "same basis (group by level first)")
        return basis

    def multiply_many(self, As, Bs) -> list[Ciphertext]:
        """B tensor+relinearize products in one ``multiply_many_banks``
        pass; bit-identical to a loop of ``multiply``."""
        if len(As) != len(Bs):
            raise ValueError(f"multiply_many: {len(As)} lhs vs {len(Bs)} rhs")
        if not As:
            return []
        for a, b in zip(As, Bs):
            check_same_basis("multiply_many", a, b)
            check_level("multiply_many", a)
        basis = self._common_basis("multiply_many", list(As) + list(Bs))
        t, fsp = self.keyswitch_tables(basis)
        eb, ea = self.relin_key(basis)
        stack = lambda ps: torch.stack([p.data for p in ps])
        c0, c1 = multiply_many_banks(stack([a.c0 for a in As]),
                                     stack([a.c1 for a in As]),
                                     stack([b.c0 for b in Bs]),
                                     stack([b.c1 for b in Bs]),
                                     eb, ea, t, fsp)
        self._count(1, key_switches=len(As), decomposes=len(As))
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           a.scale * b.scale)
                for r0, r1, a, b in zip(c0, c1, As, Bs)]

    def rescale_many(self, cts) -> list[Ciphertext]:
        """Rescale B ciphertexts (one basis) as one fused mod-down over
        all 2B halves."""
        if not cts:
            return []
        for ct in cts:
            check_level("rescale_many", ct, need=1)
        basis = self._common_basis("rescale_many", cts)
        t, fsp = self.rescale_tables(basis)
        c0, c1 = rescale_many_banks(torch.stack([ct.c0.data for ct in cts]),
                                    torch.stack([ct.c1.data for ct in cts]),
                                    t, fsp)
        self._count(1)
        rest = basis[:-1]
        return [Ciphertext(RnsPoly(r0, rest, True), RnsPoly(r1, rest, True),
                           ct.scale / basis[-1])
                for r0, r1, ct in zip(c0, c1, cts)]
