"""Encrypted slot linear algebra over the hoisted-rotation subsystem.

Rotations inside linear algebra (matvecs, slot reductions) are where real
FHE workloads spend their key switches.  Two levers keep that bill down,
both on the banks kernels:

* **Hoisting** (``evalplan.hoisted_rotations_banks``): R rotations of one
  ciphertext decompose its c1 into RNS digits once, then run R
  evaluation-domain digit gathers and R key inner products.
* **Baby-step/giant-step** (``matvec``): diagonal index r = i*n1 + j
  (j < n1 baby, i < n2 giant, n1 ~ sqrt(d_in)).  Only the n1 baby
  rotations touch the input (one hoisted pass); the n2 - 1 giant
  rotations apply to the partial sums in one mixed-amount
  ``rotate_many``.  Key switches drop from d_in - 1 to about n1 + n2 - 2,
  and the plaintext diagonals absorb the giant pre-rotations at encode
  time.

Slot layout (the diagonal method): for W of shape (d_in, d_out),
diagonal r holds diag_r[m] = W[(m + r) % d_in, m] for m < d_out, and the
input vector is TILED so slot s reads x[s % d_in] for every
s < d_in + d_out (``encode_vector``; needs d_in + d_out <= slots).  Output
slots [0, d_out) then hold y = x @ W.

A ``PtMatrix`` pack is valid at exactly ONE basis; ``matvec`` raises
``ValueError`` on any other.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.fhe import rns
from repro_torch.fhe.evalplan import (Ciphertext, EvalPlan, accumulate_banks,
                                      check_level, plain_mac_banks)
from repro_torch.fhe.rns import RnsPoly

__all__ = ["PtMatrix", "bsgs_split", "encode_vector", "matvec", "rotate_sum"]


def bsgs_split(d_in: int) -> tuple[int, int]:
    """Default BSGS split: n1 = ceil(sqrt(d_in)) baby steps, n2 =
    ceil(d_in / n1) giant steps, which minimizes n1 + n2."""
    n1 = max(1, math.isqrt(d_in - 1) + 1) if d_in > 1 else 1
    return n1, -(-d_in // n1)


@dataclasses.dataclass
class PtMatrix:
    """A plaintext matrix packed for the encrypted diagonal matvec:
    per-diagonal NTT-domain ``RnsPoly`` rows at one basis.

    diags[(i, j)] encodes diagonal r = i*n1 + j rotated by -i*n1 slots, so
    the giant-step rotation of the inner sum realigns it; all-zero
    diagonals are dropped."""
    shape: tuple[int, int]               # (d_in, d_out)
    n1: int                              # baby steps
    n2: int                              # giant steps
    basis: tuple[int, ...]               # the one basis this pack is valid at
    scale: float                         # plaintext scale of every diagonal
    diags: dict                          # (i, j) -> RnsPoly (NTT form, at basis)

    @classmethod
    def encode(cls, ctx, W, *, n1: int | None = None,
               basis: tuple[int, ...] | None = None,
               scale: float | None = None) -> "PtMatrix":
        """Pack W (d_in, d_out) for ``matvec`` under ``ctx``: one-time
        host work (encode + CRT lift + NTT per nonzero diagonal) at the
        context's full chain unless ``basis`` names another."""
        W = np.asarray(W, dtype=np.complex128)
        if W.ndim != 2:
            raise ValueError(f"PtMatrix.encode: W must be 2-D, got {W.shape}")
        d_in, d_out = W.shape
        if d_in + d_out > ctx.slots:
            raise ValueError(
                f"PtMatrix.encode: d_in + d_out = {d_in + d_out} exceeds the "
                f"{ctx.slots} slots of n={ctx.n} — the tiled input layout "
                "(encode_vector) needs d_in + d_out <= slots")
        basis = tuple(basis if basis is not None else ctx.qs)
        scale = float(scale or ctx.scale)
        if n1 is None:
            n1, n2 = bsgs_split(d_in)
        else:
            if not 1 <= n1 <= d_in:
                raise ValueError(f"PtMatrix.encode: n1={n1} outside [1, {d_in}]")
            n2 = -(-d_in // n1)
        diags: dict = {}
        m = np.arange(d_out)
        for r in range(d_in):
            diag = np.zeros(ctx.slots, dtype=np.complex128)
            diag[m] = W[(m + r) % d_in, m]
            if not np.any(diag):
                continue                     # zero diagonal: no term, no key
            i, j = divmod(r, n1)
            diags[(i, j)] = ctx.encode(np.roll(diag, i * n1), scale=scale,
                                       basis=basis)
        return cls((d_in, d_out), n1, n2, basis, scale, diags)

    @property
    def baby_set(self) -> tuple[int, ...]:
        """Baby-step rotation amounts ``matvec`` hoists (one pass)."""
        return tuple(sorted({j for (_, j) in self.diags}))

    @property
    def giant_set(self) -> tuple[int, ...]:
        """Nonzero giant-step rotation amounts (one ``rotate_many``)."""
        return tuple(sorted({i * self.n1 for (i, _) in self.diags if i}))

    def mac_pack(self):
        """(diags (D, k, n) stack, jmap, imap, gis) for
        ``plain_mac_banks``: diagonal d (sorted (i, j) order) multiplies
        baby row ``jmap[d]`` into giant group ``imap[d]``; ``gis`` lists
        the giant indices in output order.  Built once per pack."""
        cached = self.__dict__.get("_mac_pack")
        if cached is None:
            keys = sorted(self.diags)
            jrow = {j: t for t, j in enumerate(self.baby_set)}
            gis = tuple(sorted({i for (i, _) in keys}))
            grow = {i: t for t, i in enumerate(gis)}
            cached = self.__dict__["_mac_pack"] = (
                torch.stack([self.diags[ij].data for ij in keys]),
                tuple(jrow[j] for (_, j) in keys),
                tuple(grow[i] for (i, _) in keys),
                gis)
        return cached


def encode_vector(ctx, x, d_out: int, *, scale: float | None = None,
                  basis: tuple[int, ...] | None = None) -> RnsPoly:
    """Encode x (length d_in) in the tiled slot layout ``matvec`` expects:
    slot s = x[s % d_in] for s < d_in + d_out."""
    x = np.asarray(x)
    d_in = x.shape[0]
    if d_in + d_out > ctx.slots:
        raise ValueError(
            f"encode_vector: d_in + d_out = {d_in + d_out} exceeds "
            f"{ctx.slots} slots")
    z = np.zeros(ctx.slots, dtype=np.complex128)
    s = np.arange(d_in + d_out)
    z[s] = x[s % d_in]
    return ctx.encode(z, scale=scale, basis=basis)


def matvec(plan: EvalPlan, M: PtMatrix, ct: Ciphertext) -> Ciphertext:
    """Encrypted y = x @ W by BSGS diagonals: one hoisted pass for the
    baby rotations of the input, one multiply-accumulate over every giant
    group, one mixed-amount ``rotate_many`` for the giant steps, and a
    final modular sum.  ``ct`` must sit at the pack's basis; the result's
    scale is ct.scale * M.scale."""
    check_level("matvec", ct)
    if ct.primes != M.basis:
        raise ValueError(
            f"matvec: ciphertext basis {ct.primes} != the PtMatrix pack's "
            f"basis {M.basis} — a pack is valid at exactly one basis; "
            "encode the matrix at the ciphertext's level (PtMatrix.encode"
            "(..., basis=ct.primes)) or level-align the input first")
    if not M.diags:
        raise ValueError("matvec: the PtMatrix packs no nonzero diagonals")
    # baby steps (j = 0 is answered host-side inside rotate_hoisted)
    babies = plan.rotate_hoisted(ct, list(M.baby_set))
    b0 = torch.stack([b.c0.data for b in babies])
    b1 = torch.stack([b.c1.data for b in babies])
    diags, jmap, imap, gis = M.mac_pack()
    qs, mus = rns._basis_consts(M.basis, ct.c0.device)
    i0, i1 = plain_mac_banks(b0, b1, diags, qs, mus, jmap=jmap, imap=imap)
    scale = ct.scale * M.scale
    inners = {gi: Ciphertext(RnsPoly(r0, M.basis, True),
                             RnsPoly(r1, M.basis, True), scale)
              for gi, r0, r1 in zip(gis, i0, i1)}
    # giant steps: each partial sum rotated by i*n1 in one batch (i = 0
    # needs none), then one modular sum
    rotated = plan.rotate_many([inners[i] for i in gis if i],
                               [i * M.n1 for i in gis if i])
    parts = ([inners[0]] if 0 in inners else []) + rotated
    if len(parts) == 1:
        return parts[0]
    a0, a1 = accumulate_banks([p.c0.data for p in parts],
                              [p.c1.data for p in parts], qs)
    return Ciphertext(RnsPoly(a0, M.basis, True),
                      RnsPoly(a1, M.basis, True), scale)


def rotate_sum(plan: EvalPlan, ct: Ciphertext, m: int) -> Ciphertext:
    """Log-step slot reduction: slot s of the result holds
    sum_{t < m} x[(s + t) % slots].  m must be a power of two; each step
    rotates the accumulated sum, so the log2(m) rotations are a chain of
    single passes (hoisting does not apply)."""
    if m < 1 or (m & (m - 1)):
        raise ValueError(f"rotate_sum: m must be a power of two, got {m}")
    if m > plan.n // 2:
        raise ValueError(f"rotate_sum: m={m} exceeds {plan.n // 2} slots")
    acc = ct
    s = 1
    while s < m:
        acc = plan.ctx.add(acc, plan.rotate(acc, s))
        s <<= 1
    return acc
