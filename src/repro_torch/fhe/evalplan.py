"""Device-resident CKKS evaluation plan (paper Fig 1 / Fig 22).

An ``EvalPlan`` precomputes, per prime basis, the stacked tables the bank
kernels consume (TablePack for single-kernel rings, FourStepPack + scalar
pack past ``ops.FOURSTEP_MIN_N``), the stacked ``(k, k+1, n)``
relinearization and Galois key digits and the NTT-domain Galois gather
rows, then runs each scheme op as one program over raw (k, n) residue
stacks:

  multiply   -> ``multiply_banks``  (tensor product + fused batched_keyswitch)
  rescale    -> ``rescale_banks``   (both halves through one mod_down_banks)
  rotate/conjugate -> ``galois_ks_banks`` (NTT-domain gather + key switch)
  R rotations of one ct -> ``hoisted_rotations_banks`` (one digit
                decomposition, R digit gathers, R key inner products,
                one mod-down over all 2R halves)

The ``*_many`` twins take (B, k, n) leading-batch stacks: B ciphertexts
at one basis ride one pass of every kernel, bit-identical to a loop of
the single-ciphertext programs.  A Galois batch carries a gather row and
key digits per ciphertext, so one pass can mix rotation amounts.
Batching never crosses bases.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.modmath import addmod, mulmod_barrett, u32
from repro_torch.core.params import galois_eval_perm
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


def galois_ks_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """Slot rotation / conjugation: NTT-domain gather on both halves (no
    iNTT/NTT round trip), then the key switch of the permuted c1 under
    the Galois key.  c0/c1 (k, n); idx (n,); evk_b/evk_a (k, k+1, n)."""
    k = c0.shape[0]
    q = u32(t["qs"][:k])[:, None]
    c0g = ops.galois_banks(c0, idx)
    c1g = ops.galois_banks(c1, idx)
    ks0, ks1 = batched_keyswitch(c1g[:, None], evk_b, evk_a, t, fsp=fsp)
    return addmod(c0g.long(), ks0[:, 0].long(), q).int(), ks1[:, 0]


def galois_ks_many_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """B rotations / conjugations in one pass.  c0/c1: (B, k, n).  A mixed
    batch passes (B, n) gather rows and (k, k+1, B, n) per-ciphertext key
    digits; a uniform one the shared (n,) row and (k, k+1, n) digits.
    Returns (B, k, n) stacks."""
    k = c0.shape[1]
    q = u32(t["qs"][:k])[None, :, None]
    c0g = ops.galois_banks(c0, idx, batch_leading=True)
    c1g = ops.galois_banks(c1, idx, batch_leading=True)
    ks0, ks1 = batched_keyswitch(c1g.transpose(0, 1).contiguous(), evk_b,
                                 evk_a, t, fsp=fsp)
    return (addmod(c0g.long(), ks0.transpose(0, 1).long(), q).int(),
            ks1.transpose(0, 1))


def hoisted_rotations_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """R rotations of ONE ciphertext with the key-switch front half
    hoisted: c1's digit decomposition runs once, and each rotation
    gathers those digits in the evaluation domain (the automorphism
    commutes with the per-prime decomposition, so this is bit-identical
    to decomposing each rotated c1).

    c0/c1: (k, n); idx: (R, n) gather rows; evk_b/evk_a: (k, k+1, R, n)
    per-rotation key digits.  Returns (k, R, n) stacks, rotation r in
    batch column r."""
    k, _ = c0.shape
    R = idx.shape[0]
    q = u32(t["qs"][:k])[:, None, None]
    y = FB.decompose_banks(c1[:, None], t, fsp=fsp)        # (k, k+1, 1, n)
    # shared-mode gathers: the one decomposition (and c0, as a single
    # "digit") fan out to the R gather rows inside the kernel
    yg = ops.galois_digits_banks(y, idx)                    # (k, k+1, R, n)
    acc0 = ops.dyadic_inner_banks(yg, evk_b, t)             # (k+1, R, n)
    acc1 = ops.dyadic_inner_banks(yg, evk_a, t)
    ks = mod_down_banks(torch.cat([acc0, acc1], dim=1), t, fsp=fsp)
    ks0, ks1 = ks[:, :R], ks[:, R:]
    c0g = ops.galois_digits_banks(c0[None, :, None], idx)[0]
    return addmod(c0g.long(), ks0.long(), q).int(), ks1


def _modsum(parts, group, groups: int, q):
    """Sum of canonical residues (< 2^31 each) into ``groups`` rows by
    ``group`` index, reduced mod q.  The int64 sum is exact, so this is
    the same canonical residue as any order of modular adds."""
    acc = torch.zeros((groups,) + tuple(parts.shape[1:]), dtype=torch.int64,
                      device=parts.device)
    acc.index_add_(0, group, parts)
    return torch.remainder(acc, q).int()


def plain_mac_banks(b0, b1, diags, qs, mus, *, jmap, imap):
    """BSGS multiply-accumulate (the ``fhe.linalg.matvec`` inner sums):
    inner_g = sum over the diagonals d of group g of
    diags[d] * babies[jmap[d]], for every giant group at once.

    b0/b1: (R, k, n) halves of the baby rotations; diags: (D, k, n)
    plaintext diagonals; qs/mus: (k, 1) int64 Barrett columns; jmap[d] is
    diagonal d's row in the baby stack, imap[d] its giant group.  Returns
    (G, k, n) stacks in sorted group order."""
    rank = {g: i for i, g in enumerate(sorted(set(imap)))}
    group = torch.tensor([rank[g] for g in imap], device=diags.device)
    rows = torch.tensor(list(jmap), device=diags.device)
    d = diags.long()
    p0 = mulmod_barrett(d, b0[rows].long(), qs, mus)
    p1 = mulmod_barrett(d, b1[rows].long(), qs, mus)
    return (_modsum(p0, group, len(rank), qs),
            _modsum(p1, group, len(rank), qs))


def accumulate_banks(parts0, parts1, qs):
    """Modular sum of L ciphertext halves: parts0/parts1 are nonempty
    lists of (k, n) canonical stacks, qs the (k, 1) prime column.  The
    int64 sum is exact, so this equals any order of modular adds."""
    return tuple(torch.remainder(torch.stack(parts).long().sum(0), qs).int()
                 for parts in (parts0, parts1))


class EvalPlan:
    """Precomputed device tables + stacked keys for one CkksContext.

    ``stats`` counts, per plan:
      dispatches   scheme programs run
      key_switches key-switch inner products applied (the paper's Fig 22
                   op, the unit of its key-switch rate)
      decomposes   RNS digit decompositions paid; R hoisted rotations
                   count R key switches but 1 decompose
    """

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.n
        self.device = ctx.device
        self.natural = self.n >= ops.FOURSTEP_MIN_N
        self._keys: dict = {}        # ('relin', basis) | ('galois', g, basis)
        self._batch_keys: dict = {}  # (gs, basis) -> stacked, bounded LRU
        self._idx: dict = {}         # g -> (n,) int32 gather row
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

    def _stacked(self, key, make):
        if key not in self._keys:
            evk = make()
            self._keys[key] = (torch.stack([p[0].data for p in evk]),
                               torch.stack([p[1].data for p in evk]))
        return self._keys[key]

    def relin_key(self, basis: tuple[int, ...]):
        """(k, k+1, n) stacked relinearization key digit tensors."""
        return self._stacked(("relin", basis),
                             lambda: self.ctx.relin_keys(basis))

    def galois_key(self, g: int, basis: tuple[int, ...]):
        """(k, k+1, n) stacked Galois key digit tensors for sigma_g."""
        return self._stacked(("galois", g, basis),
                             lambda: self.ctx.galois_keys(g, basis))

    # A mixed batch's stacked keys are (k, k+1, B, n) x2 per pattern of
    # group elements, so their cache is a bounded LRU: traffic that
    # repeats a pattern stays resident, random traffic evicts.
    _BATCH_KEY_CACHE_MAX = 32

    def _galois_batch_key(self, gs: tuple[int, ...], basis: tuple[int, ...]):
        """(k, k+1, B, n) per-ciphertext key stacks + (B, n) gather rows
        for a batch of automorphisms gs, cached per (gs, basis)."""
        key = (gs, basis)
        if key in self._batch_keys:
            self._batch_keys[key] = self._batch_keys.pop(key)   # LRU touch
        else:
            if len(self._batch_keys) >= self._BATCH_KEY_CACHE_MAX:
                self._batch_keys.pop(next(iter(self._batch_keys)))
            keys = [self.galois_key(g, basis) for g in gs]
            self._batch_keys[key] = (
                torch.stack([kb for kb, _ in keys], dim=2),    # (k, k+1, B, n)
                torch.stack([ka for _, ka in keys], dim=2),
                torch.stack([self.eval_idx(g) for g in gs]))
        return self._batch_keys[key]

    def eval_idx(self, g: int) -> torch.Tensor:
        """(n,) int32 NTT-domain gather row for sigma_g in this ring's
        frequency order (natural past the four-step threshold, bitrev
        below it)."""
        if g not in self._idx:
            perm = galois_eval_perm(g, self.n, self.natural)
            self._idx[g] = torch.from_numpy(perm.astype("int32")).to(self.device)
        return self._idx[g]

    def rotation_group_element(self, r: int) -> int:
        return pow(5, r, 2 * self.n)

    def prepare(self, basis: tuple[int, ...] | None = None, rotations=(),
                conjugate: bool = False, hoisted_sets=(), matvecs=()):
        """Build every table, key and gather row a serving loop will need,
        so no request pays keygen or table construction.  ``rotations``
        and ``conjugate`` name the single and batched rotations to key,
        ``hoisted_sets`` the rotation-amount sets of ``rotate_hoisted``,
        ``matvecs`` ``fhe.linalg.PtMatrix`` packs (their baby and giant
        steps, at the pack's own basis).  Keys are drawn from the
        context's generator in the reference's order, so the same
        prepare gives the same keys.  The counters are reset on exit."""
        basis = tuple(basis if basis is not None else self.ctx.qs)
        self.keyswitch_tables(basis)
        self.rescale_tables(basis)
        self.relin_key(basis)
        gs = [g for g in (self.rotation_group_element(r) for r in rotations)
              if g != 1]
        if conjugate:
            gs.append(2 * self.n - 1)
        hoist_gs = {self.rotation_group_element(r)
                    for rset in hoisted_sets for r in rset} - {1}
        for g in gs + sorted(hoist_gs - set(gs)):
            self.galois_key(g, basis)
            self.eval_idx(g)
        for M in matvecs:
            mv_basis = tuple(M.basis)
            self.keyswitch_tables(mv_basis)
            for r in set(M.baby_set) | set(M.giant_set):
                g = self.rotation_group_element(r)
                if g != 1:
                    self.galois_key(g, mv_basis)
                    self.eval_idx(g)
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

    def galois_ks_many(self, cts, gs) -> list[Ciphertext]:
        """B automorphisms (one basis, group elements gs, possibly mixed)
        in one ``galois_ks_many_banks`` pass.  A uniform batch keeps the
        shared (k, k+1, n) key and (n,) gather row; a mixed one stacks a
        key and a row per ciphertext."""
        if len(cts) != len(gs):
            raise ValueError(f"galois_ks_many: {len(cts)} cts vs {len(gs)} gs")
        if not cts:
            return []
        for ct in cts:
            check_level("galois_ks_many", ct)
        basis = self._common_basis("galois_ks_many", cts)
        t, fsp = self.keyswitch_tables(basis)
        if len(set(gs)) == 1:
            eb, ea = self.galois_key(gs[0], basis)
            idx = self.eval_idx(gs[0])
        else:
            eb, ea, idx = self._galois_batch_key(tuple(gs), basis)
        c0, c1 = galois_ks_many_banks(torch.stack([ct.c0.data for ct in cts]),
                                      torch.stack([ct.c1.data for ct in cts]),
                                      idx, eb, ea, t, fsp)
        self._count(1, key_switches=len(cts), decomposes=len(cts))
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           ct.scale)
                for r0, r1, ct in zip(c0, c1, cts)]

    def apply_galois(self, a: Ciphertext, g: int) -> Ciphertext:
        check_level("apply_galois", a)
        basis = a.primes
        t, fsp = self.keyswitch_tables(basis)
        eb, ea = self.galois_key(g, basis)
        c0, c1 = galois_ks_banks(a.c0.data, a.c1.data, self.eval_idx(g),
                                 eb, ea, t, fsp)
        self._count(1, key_switches=1, decomposes=1)
        return Ciphertext(RnsPoly(c0, basis, True), RnsPoly(c1, basis, True),
                          a.scale)

    def rotate(self, a: Ciphertext, r: int) -> Ciphertext:
        g = self.rotation_group_element(r)
        if g == 1:                       # identity automorphism: no launch
            return Ciphertext(a.c0, a.c1, a.scale)
        return self.apply_galois(a, g)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, 2 * self.n - 1)

    # R rotations of ONE ciphertext pay ONE digit decomposition: the
    # primitive the ``fhe.linalg`` BSGS matvec baby steps run on.

    def hoisted_galois(self, a: Ciphertext, gs) -> list[Ciphertext]:
        """Apply R automorphisms ``gs`` (need not be distinct) to ``a`` in
        one ``hoisted_rotations_banks`` pass; bit-identical to
        ``[self.apply_galois(a, g) for g in gs]``."""
        gs = tuple(gs)
        if not gs:
            return []
        check_level("hoisted_galois", a)
        basis = a.primes
        t, fsp = self.keyswitch_tables(basis)
        eb, ea, idx = self._galois_batch_key(gs, basis)
        c0, c1 = hoisted_rotations_banks(a.c0.data, a.c1.data, idx, eb, ea,
                                         t, fsp)
        self._count(1, key_switches=len(gs), decomposes=1)
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           a.scale)
                for r0, r1 in zip(c0.unbind(1), c1.unbind(1))]

    def rotate_hoisted(self, a: Ciphertext, rs) -> list[Ciphertext]:
        """Rotate one ciphertext by every amount in ``rs`` with the
        decomposition hoisted.  Identity amounts (r = 0 mod slots) are
        answered host-side, like ``rotate``."""
        gs = [self.rotation_group_element(r) for r in rs]
        live = [i for i, g in enumerate(gs) if g != 1]
        out = [Ciphertext(a.c0, a.c1, a.scale) for _ in gs]
        if live:
            rotated = self.hoisted_galois(a, tuple(gs[i] for i in live))
            for i, ct in zip(live, rotated):
                out[i] = ct
        return out

    def rotate_many(self, cts, rs) -> list[Ciphertext]:
        """Rotate B ciphertexts by per-ciphertext amounts ``rs`` in one
        pass (identity rotations are returned as they are, like
        ``rotate``; the rest batch through ``galois_ks_many``)."""
        if len(cts) != len(rs):
            raise ValueError(f"rotate_many: {len(cts)} cts vs {len(rs)} rs")
        gs = [self.rotation_group_element(r) for r in rs]
        live = [i for i, g in enumerate(gs) if g != 1]
        out = [Ciphertext(ct.c0, ct.c1, ct.scale) for ct in cts]
        if live:
            rotated = self.galois_ks_many([cts[i] for i in live],
                                          [gs[i] for i in live])
            for i, ct in zip(live, rotated):
                out[i] = ct
        return out

    def conjugate_many(self, cts) -> list[Ciphertext]:
        return self.galois_ks_many(cts, [2 * self.n - 1] * len(cts))
