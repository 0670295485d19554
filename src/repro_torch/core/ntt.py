"""Constant-geometry (Pease) NTT for one prime — the paper's core
dataflow — in PyTorch.

Every stage uses the same out-of-place access pattern (the paper's FIFO
shift registers need no random access), so a stage is a reshape and an
interleave, and the transform a Python loop over the (stages, n/2)
twiddle rows.

Forward network (CG-DIT, natural order in -> bit-reversed out), stage t:
    out[2j]   = x[j] + w_t[j] * x[j + n/2]
    out[2j+1] = x[j] - w_t[j] * x[j + n/2]          (paper eq. (3)/(7))
Inverse network (CG-GS, bit-reversed in -> natural out), stage t desc:
    out[j]       = x[2j] + x[2j+1]
    out[j + n/2] = (x[2j] - x[2j+1]) * w_t[j]^-1
followed by a single fused multiply by n^-1.

Residue tensors are int32 holding uint32 values (``convert``); the
functions widen them to int64 and run ``core.modmath``'s u32 lane, so
lazy [0, 2q) representatives match the JAX reference and the CUDA
kernels bit for bit.  They run on any device.  These are the plain
versions of the single-prime kernels ``ntt_fwd`` / ``ntt_inv``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import u32_to_tensor
from repro_torch.core.modmath import (addmod, lazy_addmod, lazy_submod,
                                      mulmod_shoup, mulmod_shoup_lazy,
                                      submod, u32)
from repro_torch.core.params import NTTParams, bitrev_perm

TABLES = ("tw", "twp", "itw", "itwp", "psi_pows", "psi_pows_p", "ipsi_ninv",
          "ipsi_ninv_p")
_TABLES: dict = {}


def device_tables(p: NTTParams, device) -> dict:
    """``p``'s tables (``TABLES``) as int32 tensors on ``device``, moved
    once per (n, q, psi, device)."""
    device = torch.device(device)
    key = (p.n, p.q, p.psi, str(device))
    if key not in _TABLES:
        _TABLES[key] = {name: u32_to_tensor(getattr(p, name), device)
                        for name in TABLES}
    return _TABLES[key]


def _fwd_stage(v, w, wp, q, lazy):
    h = v.shape[-1] // 2
    lo, hi = v[..., :h], v[..., h:]
    if lazy:
        # [0, 2q) band: the Shoup product skips its final subtract and
        # add/sub reduce only past 2q
        t = mulmod_shoup_lazy(hi, w, wp, q)
        u, d = lazy_addmod(lo, t, q), lazy_submod(lo, t, q)
    else:
        t = mulmod_shoup(hi, w, wp, q)
        u, d = addmod(lo, t, q), submod(lo, t, q)
    return torch.stack([u, d], dim=-1).reshape(v.shape)


def _inv_stage(v, w, wp, q, lazy):
    e, o = v[..., 0::2], v[..., 1::2]
    if lazy:
        u = lazy_addmod(e, o, q)
        d = mulmod_shoup_lazy(lazy_submod(e, o, q), w, wp, q)
    else:
        u = addmod(e, o, q)
        d = mulmod_shoup(submod(e, o, q), w, wp, q)
    return torch.cat([u, d], dim=-1)


def cg_ntt(x, tw, twp, q: int, lazy: bool = False, reduce_out: bool = True):
    """Batched forward CG-NTT.  x: (..., n) int32 in [0, q); tw/twp:
    (s, n/2) int32 twiddle rows and Shoup companions.  Output in
    bit-reversed order (the paper's native output order).

    ``lazy`` keeps values in [0, 2q) between stages; ``reduce_out=False``
    additionally skips the epilogue reduce for a lazy-aware consumer.
    Eager mode is always fully reduced."""
    v = u32(x)
    w, wp = u32(tw), u32(twp)
    for t in range(w.shape[0]):
        v = _fwd_stage(v, w[t], wp[t], q, lazy)
    if lazy and reduce_out:
        v = torch.where(v >= q, v - q, v)
    return v.int()


def cg_intt(x, itw, itwp, ninv: int, ninv_p: int, q: int,
            apply_ninv: bool = True, lazy: bool = False,
            reduce_out: bool = True):
    """Batched inverse CG-NTT: bit-reversed order in, natural order out,
    stages in descending t.  In lazy mode the n^-1 epilogue multiply
    doubles as the exact reduction (``mulmod_shoup`` takes any u32
    representative)."""
    v = u32(x)
    w, wp = u32(itw), u32(itwp)
    for t in range(w.shape[0] - 1, -1, -1):
        v = _inv_stage(v, w[t], wp[t], q, lazy)
    if apply_ninv:
        mul = mulmod_shoup_lazy if (lazy and not reduce_out) else mulmod_shoup
        v = mul(v, ninv, ninv_p, q)
    elif lazy and reduce_out:
        v = torch.where(v >= q, v - q, v)
    return v.int()


# ------------------------------------------------------------ negacyclic

def ntt_negacyclic(a, p: NTTParams, lazy: bool = False):
    """NTT over Z_q[x]/(x^n+1): pre-weight by psi^i then cyclic CG-NTT."""
    t = device_tables(p, a.device)
    mul = mulmod_shoup_lazy if lazy else mulmod_shoup
    a = mul(u32(a), u32(t["psi_pows"]), u32(t["psi_pows_p"]), p.q)
    return cg_ntt(a, t["tw"], t["twp"], p.q, lazy=lazy)


def intt_negacyclic(A, p: NTTParams, lazy: bool = False):
    """Inverse negacyclic NTT with the n^-1 factor fused into the psi^-i
    post-weight row; the post-weight multiply is the exact-reduction
    epilogue either way."""
    t = device_tables(p, A.device)
    a = cg_intt(A, t["itw"], t["itwp"], p.ninv, p.ninv_p, p.q,
                apply_ninv=False, lazy=lazy, reduce_out=False)
    return mulmod_shoup(u32(a), u32(t["ipsi_ninv"]), u32(t["ipsi_ninv_p"]),
                        p.q).int()


def ntt_cyclic(a, p: NTTParams, lazy: bool = False):
    t = device_tables(p, a.device)
    return cg_ntt(a, t["tw"], t["twp"], p.q, lazy=lazy)


def intt_cyclic(A, p: NTTParams, lazy: bool = False):
    t = device_tables(p, A.device)
    return cg_intt(A, t["itw"], t["itwp"], p.ninv, p.ninv_p, p.q, lazy=lazy)


# ------------------------------------------------------- numpy oracles

_LIMB_BITS = 11          # three limbs cover a uint32 operand


def _linear_mod(a, fn, q: int) -> np.ndarray:
    """fn(a) mod q, exact, for a linear map ``fn`` over int64 whose sums
    have fewer than 2^19 terms, each an ``a`` entry times a value below
    2^32: ``a`` is split into 11-bit limbs so no int64 sum overflows."""
    a = np.asarray(a, dtype=np.int64)
    out = 0
    for i in range(3):
        limb = (a >> (_LIMB_BITS * i)) & ((1 << _LIMB_BITS) - 1)
        out = (out + (fn(limb) % q) * (1 << (_LIMB_BITS * i))) % q
    return np.asarray(out, dtype=np.int64)


def brute_ntt_np(a: np.ndarray, omega: int, q: int) -> np.ndarray:
    """Paper §VII.C golden model: direct evaluation of eq. (1), O(n^2).
    Natural frequency order."""
    n = a.shape[-1]
    opow = np.ones(n, dtype=np.int64)
    for i in range(1, n):
        opow[i] = opow[i - 1] * omega % q
    r = np.arange(n)
    wmat = opow[np.outer(r, r) % n]
    return _linear_mod(a, lambda v: v @ wmat.T, q).astype(np.uint32)


def brute_ntt_bitrev_np(a: np.ndarray, omega: int, q: int) -> np.ndarray:
    """Golden model permuted to the CG network's bit-reversed output."""
    return brute_ntt_np(a, omega, q)[..., bitrev_perm(a.shape[-1])]


def negacyclic_convolve_np(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Schoolbook negacyclic convolution (x^n = -1) of two length-n rows,
    exact."""
    n = len(a)
    bb = np.asarray(b, dtype=np.int64)

    def wrap(v):
        c = np.convolve(v, bb)
        out = c[:n].copy()
        out[:n - 1] -= c[n:]
        return out

    return _linear_mod(a, wrap, q).astype(np.uint32)
