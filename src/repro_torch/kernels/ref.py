"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

Same op sequence as the CUDA kernels and as the JAX reference's
``kernels/ref.py``, on int64 tensors that hold the lane's unsigned
values, so even the lazy [0, 2q) representatives match bit for bit.
The lane follows the dtype, as the reference's follows uint32/uint16:
int32 inputs and outputs are the RNS lane (residues below 2^31,
constants as uint32 bit patterns), int16 ones the small-ring lane of
``core.ringspec`` (ML-KEM; constants as uint16 bit patterns, 16-bit
Shoup and Barrett).  They run on any device; the wrappers take them
only for CPU tensors, and the chip smoke test runs them on the card to
hold each kernel against.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import ntt as _ntt
from repro_torch.core.modmath import (addmod, lazy_addmod, lazy_submod,
                                      mulmod_barrett, mulmod_barrett_lazy,
                                      mulmod_shoup, mulmod_shoup_lazy, submod,
                                      u16, u32)
from repro_torch.core.params import NTTParams
from repro_torch.kernels import COUNTS


def lane_bits(x: torch.Tensor) -> int:
    """16 for the int16 small-ring lane, 32 for the int32 RNS lane."""
    return 16 if x.dtype == torch.int16 else 32


def _widen(t: torch.Tensor) -> torch.Tensor:
    """Bit-pattern tensor -> int64 holding the lane's unsigned value."""
    return u16(t) if t.dtype == torch.int16 else u32(t)


def _narrow(v: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 lane values -> the lane's storage dtype, bit pattern kept."""
    return v.to(torch.int16) if bits == 16 else v.int()


def _per_prime(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(k, m) table rows (or (k,) scalars) -> (k, 1, ..., m) int64 lane
    values broadcasting against a (k, ..., n) stack of ``ndim`` dims."""
    k = t.shape[0]
    m = t.shape[1] if t.ndim > 1 else 1
    return _widen(t).reshape((k,) + (1,) * (ndim - 2) + (m,))


def _shoup_pair(bits: int):
    """(lazy, eager) Shoup multiplies of the lane."""
    return (functools.partial(mulmod_shoup_lazy, bits=bits),
            functools.partial(mulmod_shoup, bits=bits))


# ------------------------------------------------------ single prime

def ntt_fwd_ref(x, p: NTTParams, negacyclic: bool, lazy: bool = False):
    """Single-prime forward NTT of x (..., n) int32: ``core.ntt``'s
    functions, which keep the kernel's lazy-band order."""
    COUNTS["ntt_fwd"].plain_calls += 1
    if negacyclic:
        return _ntt.ntt_negacyclic(x, p, lazy=lazy)
    return _ntt.ntt_cyclic(x, p, lazy=lazy)


def ntt_inv_ref(x, p: NTTParams, negacyclic: bool, lazy: bool = False):
    COUNTS["ntt_inv"].plain_calls += 1
    if negacyclic:
        return _ntt.intt_negacyclic(x, p, lazy=lazy)
    return _ntt.intt_cyclic(x, p, lazy=lazy)


def dyadic_mul_ref(a, b, q: int, mu: int, lazy: bool = False):
    """a * b mod q with the u32 Barrett product; lazy takes the [0, 2q)
    band and then one subtract of q."""
    COUNTS["dyadic_mul"].plain_calls += 1
    av, bv = u32(a), u32(b)
    if lazy:
        r = mulmod_barrett_lazy(av, bv, q, mu)
        return torch.where(r >= q, r - q, r).int()
    return mulmod_barrett(av, bv, q, mu).int()


def dyadic_mac_ref(acc, a, b, q: int, mu: int, lazy: bool = False):
    """acc + a * b mod q; lazy sums acc (< q) and the [0, 2q) product
    (< 3q), then reduces by 2q and by q."""
    COUNTS["dyadic_mac"].plain_calls += 1
    av, bv, s = u32(a), u32(b), u32(acc)
    if lazy:
        s = s + mulmod_barrett_lazy(av, bv, q, mu)
        s = torch.where(s >= 2 * q, s - 2 * q, s)
        return torch.where(s >= q, s - q, s).int()
    return addmod(s, mulmod_barrett(av, bv, q, mu), q).int()


# ------------------------------------------------ multi-prime banks

def ntt_fwd_banks_ref(x, qs, tw, twp, pre, prep, negacyclic: bool,
                      lazy: bool = False, reduce_out: bool = True):
    """Multi-prime forward constant-geometry NTT.  x: (k, ..., n) with row
    p reduced mod qs[p]; tw/twp: (k, s, n/2), s <= log2 n stages;
    pre/prep: (k, n)."""
    bits = lane_bits(x)
    COUNTS["ntt_fwd_banks_u16" if bits == 16 else "ntt_fwd_banks"].plain_calls += 1
    shoup_lazy, shoup = _shoup_pair(bits)
    nd = x.ndim
    q = _per_prime(qs, nd)
    v = _widen(x)
    if negacyclic:
        mul = shoup_lazy if lazy else shoup
        v = mul(v, _per_prime(pre, nd), _per_prime(prep, nd), q)
    h = x.shape[-1] // 2
    for t in range(tw.shape[1]):
        w, wp = _per_prime(tw[:, t], nd), _per_prime(twp[:, t], nd)
        lo, hi = v[..., :h], v[..., h:]
        if lazy:
            tt = shoup_lazy(hi, w, wp, q)
            u, d = lazy_addmod(lo, tt, q), lazy_submod(lo, tt, q)
        else:
            tt = shoup(hi, w, wp, q)
            u, d = addmod(lo, tt, q), submod(lo, tt, q)
        v = torch.stack([u, d], dim=-1).reshape(v.shape)
    if lazy and reduce_out:
        v = torch.where(v >= q, v - q, v)
    return _narrow(v, bits)


def ntt_inv_banks_ref(x, qs, ninv, ninv_p, itw, itwp, post, postp,
                      negacyclic: bool, lazy: bool = False,
                      reduce_out: bool = True):
    """Multi-prime inverse (Gentleman-Sande) stages in descending order,
    then the epilogue multiply by the psi^-i * n^-1 row (negacyclic) or
    the ninv scalar (n^-1, or 2^-stages for an incomplete ring), which
    reduces fully unless ``lazy`` and not ``reduce_out``."""
    bits = lane_bits(x)
    COUNTS["ntt_inv_banks_u16" if bits == 16 else "ntt_inv_banks"].plain_calls += 1
    shoup_lazy, shoup = _shoup_pair(bits)
    nd = x.ndim
    q = _per_prime(qs, nd)
    v = _widen(x)
    for t in range(itw.shape[1] - 1, -1, -1):
        w, wp = _per_prime(itw[:, t], nd), _per_prime(itwp[:, t], nd)
        e, o = v[..., 0::2], v[..., 1::2]
        if lazy:
            u = lazy_addmod(e, o, q)
            d = shoup_lazy(lazy_submod(e, o, q), w, wp, q)
        else:
            u = addmod(e, o, q)
            d = shoup(submod(e, o, q), w, wp, q)
        v = torch.cat([u, d], dim=-1)
    mul = shoup_lazy if (lazy and not reduce_out) else shoup
    if negacyclic:
        return _narrow(mul(v, _per_prime(post, nd), _per_prime(postp, nd), q), bits)
    return _narrow(mul(v, _per_prime(ninv, nd), _per_prime(ninv_p, nd), q), bits)


def twiddle_mul_banks_ref(x, qs, w, wp, lazy: bool = False):
    """x (k, ..., n) times per-prime weight rows w/wp (k, n) mod qs (k,);
    any u32 input representative is accepted (words of 2^31 and above
    arrive as negative int32 bit patterns)."""
    COUNTS["twiddle_mul_banks"].plain_calls += 1
    nd = x.ndim
    mul = mulmod_shoup_lazy if lazy else mulmod_shoup
    return mul(u32(x), _per_prime(w, nd), _per_prime(wp, nd),
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


def _take(idx: torch.Tensor, n: int):
    """The gather indices of ``jnp.take`` / ``take_along_axis``: an index
    in [-n, 0) counts from the end of the row (n + i); any other outside
    [0, n) reads word 0 here and is marked in ``ok`` for the fill."""
    i = torch.where(idx < 0, idx + n, idx)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, i, torch.zeros_like(i)), ok


def _fill(out: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Words gathered through an index outside [-n, n) become all ones
    (0xFFFFFFFF on the lane, -1 as an int32 bit pattern), as the
    reference's unsigned fill."""
    return torch.where(ok, out, torch.full_like(out, -1))


def galois_banks_ref(x, idx):
    """NTT-domain Galois automorphism: a gather along the lane axis, the
    same for every prime row.  x: (k, ..., n); idx: (n,) int32 shared by
    every row, or (B, n) per-batch rows aligned with x's (k, B, n)
    middle axis.  Indices follow ``_take``."""
    i, ok = _take(idx, x.shape[-1])
    if idx.ndim == 2:
        COUNTS["galois_banks_multi"].plain_calls += 1
        return _fill(torch.gather(x, -1, i[None].expand(x.shape)), ok[None])
    COUNTS["galois_banks"].plain_calls += 1
    return _fill(torch.index_select(x, -1, i), ok)


def galois_digits_banks_ref(x, idx):
    """Digit-extension gather (the hoisted-rotation move): x (d, k, B, n),
    idx (B, n) per-batch rows shared by every digit and prime row:
    out[d, p, b, j] = x[d, p, b, idx[b, j]].  A (d, k, 1, n) x against a
    (B, n) idx with B > 1 fans the one shared digit stack out to every
    gather row: out[d, p, b, j] = x[d, p, 0, idx[b, j]].  Indices follow
    ``_take``."""
    COUNTS["galois_digits"].plain_calls += 1
    i, ok = _take(idx, x.shape[-1])
    if x.shape[2] == 1 and idx.shape[0] != 1:
        d, k, _, n = x.shape
        out = torch.index_select(x.reshape(d, k, n), -1, i.reshape(-1))
        return _fill(out.reshape(d, k, idx.shape[0], n), ok[None, None])
    return _fill(torch.gather(x, -1, i[None, None].expand(x.shape)), ok[None, None])


def dyadic_basemul_banks_ref(a, b, qs, mus, gamma, gammap, lazy: bool = False):
    """Degree-1 basecase multiplication of an incomplete ring (block=2)
    on the int16 lane: a, b (k, ..., n) canonical NTT-domain operands,
    pair j = (x[j], x[j + n/2]); gamma/gammap (k, n/2) per-pair ζ factors
    and their Shoup companions; qs/mus (k,).

        c0[j] = a0·b0 + γ_j·(a1·b1)      c1[j] = a0·b1 + a1·b0

    The kernel's op sequence: Barrett for var×var, Shoup for γ, sums in
    the [0, 2q) band when ``lazy``; the output is always in [0, q)."""
    COUNTS["dyadic_basemul_banks"].plain_calls += 1
    bits = 16
    nd = a.ndim
    h = a.shape[-1] // 2
    q = _per_prime(qs, nd)
    mu = _per_prime(mus, nd)
    g = _per_prime(gamma, nd)
    gp = _per_prime(gammap, nd)
    av, bv = _widen(a), _widen(b)
    a0, a1 = av[..., :h], av[..., h:]
    b0, b1 = bv[..., :h], bv[..., h:]
    if lazy:
        bar = functools.partial(mulmod_barrett_lazy, q=q, mu=mu, bits=bits)
        q2 = q + q
        t = mulmod_shoup_lazy(bar(a1, b1), g, gp, q, bits=bits)
        s0 = bar(a0, b0) + t
        c0 = torch.where(s0 >= q2, s0 - q2, s0)
        s1 = bar(a0, b1) + bar(a1, b0)
        c1 = torch.where(s1 >= q2, s1 - q2, s1)
        c0 = torch.where(c0 >= q, c0 - q, c0)
        c1 = torch.where(c1 >= q, c1 - q, c1)
    else:
        bar = functools.partial(mulmod_barrett, q=q, mu=mu, bits=bits)
        t = mulmod_shoup(bar(a1, b1), g, gp, q, bits=bits)
        s0 = bar(a0, b0) + t
        c0 = torch.where(s0 >= q, s0 - q, s0)
        s1 = bar(a0, b1) + bar(a1, b0)
        c1 = torch.where(s1 >= q, s1 - q, s1)
    return _narrow(torch.cat([c0, c1], dim=-1), bits)
