"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

Same op sequence as the CUDA kernels and as the JAX reference's
``kernels/ref.py``, on int64 tensors that hold u32 values, so even the
lazy [0, 2q) representatives match bit for bit.  Inputs and outputs are
int32 (residues below 2^31; constants as uint32 bit patterns).  They run
on any device; the wrappers take them only for CPU tensors, and the
chip smoke test runs them on the card to hold each kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.core.modmath import (addmod, lazy_addmod, lazy_submod,
                                      mulmod_barrett, mulmod_barrett_lazy,
                                      mulmod_shoup, mulmod_shoup_lazy, submod,
                                      u32)
from repro_torch.kernels import COUNTS


def _per_prime(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(k, m) table rows (or (k,) scalars) -> (k, 1, ..., m) int64 u32
    values broadcasting against a (k, ..., n) stack of ``ndim`` dims."""
    k = t.shape[0]
    m = t.shape[1] if t.ndim > 1 else 1
    return u32(t).reshape((k,) + (1,) * (ndim - 2) + (m,))


def ntt_fwd_banks_ref(x, qs, tw, twp, pre, prep, negacyclic: bool,
                      lazy: bool = False, reduce_out: bool = True):
    """Multi-prime forward constant-geometry NTT.  x: (k, ..., n) with row
    p reduced mod qs[p]; tw/twp: (k, s, n/2); pre/prep: (k, n)."""
    COUNTS["ntt_fwd_banks"].plain_calls += 1
    nd = x.ndim
    q = _per_prime(qs, nd)
    v = x.long()
    if negacyclic:
        mul = mulmod_shoup_lazy if lazy else mulmod_shoup
        v = mul(v, _per_prime(pre, nd), _per_prime(prep, nd), q)
    h = x.shape[-1] // 2
    for t in range(tw.shape[1]):
        w, wp = _per_prime(tw[:, t], nd), _per_prime(twp[:, t], nd)
        lo, hi = v[..., :h], v[..., h:]
        if lazy:
            tt = mulmod_shoup_lazy(hi, w, wp, q)
            u, d = lazy_addmod(lo, tt, q), lazy_submod(lo, tt, q)
        else:
            tt = mulmod_shoup(hi, w, wp, q)
            u, d = addmod(lo, tt, q), submod(lo, tt, q)
        v = torch.stack([u, d], dim=-1).reshape(v.shape)
    if lazy and reduce_out:
        v = torch.where(v >= q, v - q, v)
    return v.int()


def ntt_inv_banks_ref(x, qs, ninv, ninv_p, itw, itwp, post, postp,
                      negacyclic: bool, lazy: bool = False,
                      reduce_out: bool = True):
    """Multi-prime inverse (Gentleman-Sande) stages in descending order,
    then the epilogue multiply by the psi^-i * n^-1 row (negacyclic) or
    the n^-1 scalar, which reduces fully unless ``lazy`` and not
    ``reduce_out``."""
    COUNTS["ntt_inv_banks"].plain_calls += 1
    nd = x.ndim
    q = _per_prime(qs, nd)
    v = x.long()
    for t in range(itw.shape[1] - 1, -1, -1):
        w, wp = _per_prime(itw[:, t], nd), _per_prime(itwp[:, t], nd)
        e, o = v[..., 0::2], v[..., 1::2]
        if lazy:
            u = lazy_addmod(e, o, q)
            d = mulmod_shoup_lazy(lazy_submod(e, o, q), w, wp, q)
        else:
            u = addmod(e, o, q)
            d = mulmod_shoup(submod(e, o, q), w, wp, q)
        v = torch.cat([u, d], dim=-1)
    mul = mulmod_shoup_lazy if (lazy and not reduce_out) else mulmod_shoup
    if negacyclic:
        return mul(v, _per_prime(post, nd), _per_prime(postp, nd), q).int()
    return mul(v, _per_prime(ninv, nd), _per_prime(ninv_p, nd), q).int()


def twiddle_mul_banks_ref(x, qs, w, wp, lazy: bool = False):
    """x (k, ..., n) times per-prime weight rows w/wp (k, n) mod qs (k,);
    any u32 input representative is accepted."""
    COUNTS["twiddle_mul_banks"].plain_calls += 1
    nd = x.ndim
    mul = mulmod_shoup_lazy if lazy else mulmod_shoup
    return mul(x.long(), _per_prime(w, nd), _per_prime(wp, nd),
               _per_prime(qs, nd)).int()


def dyadic_inner_banks_ref(ext, evk, qs, mus, lazy: bool = False):
    """ext: (d, k, B, n); evk: (d, k, n) shared or (d, k, B, n) per-batch
    key digits; qs/mus: (k,).  Digit products accumulated in the
    kernel's order."""
    COUNTS["dyadic_inner_banks"].plain_calls += 1
    q = u32(qs)[:, None, None]
    mu = u32(mus)[:, None, None]
    e = ext.long()
    key = (evk if evk.ndim == 4 else evk[:, :, None, :]).long()
    if lazy:
        acc = mulmod_barrett_lazy(e[0], key[0], q, mu)
        for i in range(1, e.shape[0]):
            acc = lazy_addmod(acc, mulmod_barrett_lazy(e[i], key[i], q, mu), q)
        return torch.where(acc >= q, acc - q, acc).int()
    acc = mulmod_barrett(e[0], key[0], q, mu)
    for i in range(1, e.shape[0]):
        acc = addmod(acc, mulmod_barrett(e[i], key[i], q, mu), q)
    return acc.int()


def galois_banks_ref(x, idx):
    """NTT-domain Galois automorphism: a gather along the lane axis, the
    same for every prime row.  x: (k, ..., n); idx: (n,) int32 shared by
    every row, or (B, n) per-batch rows aligned with x's (k, B, n)
    middle axis."""
    if idx.ndim == 2:
        COUNTS["galois_banks_multi"].plain_calls += 1
        return torch.gather(x, -1, idx[None].expand(x.shape))
    COUNTS["galois_banks"].plain_calls += 1
    return torch.index_select(x, -1, idx)


def galois_digits_banks_ref(x, idx):
    """Digit-extension gather (the hoisted-rotation move): x (d, k, B, n),
    idx (B, n) per-batch rows shared by every digit and prime row:
    out[d, p, b, j] = x[d, p, b, idx[b, j]].  A (d, k, 1, n) x against a
    (B, n) idx with B > 1 fans the one shared digit stack out to every
    gather row: out[d, p, b, j] = x[d, p, 0, idx[b, j]]."""
    COUNTS["galois_digits"].plain_calls += 1
    if x.shape[2] == 1 and idx.shape[0] != 1:
        d, k, _, n = x.shape
        out = torch.index_select(x.reshape(d, k, n), -1, idx.reshape(-1))
        return out.reshape(d, k, idx.shape[0], n)
    return torch.gather(x, -1, idx[None, None].expand(x.shape))
