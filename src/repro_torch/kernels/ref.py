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
from repro_torch.core.params import NTTParams, bitrev_perm
from repro_torch.kernels import COUNTS
from repro_torch.pq import codec


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
    COUNTS["ntt_fwd_banks_u16" if lane_bits(x) == 16 else "ntt_fwd_banks"].plain_calls += 1
    return _fwd_banks(x, qs, tw, twp, pre, prep, negacyclic, lazy, reduce_out)


def _fwd_banks(x, qs, tw, twp, pre, prep, negacyclic, lazy, reduce_out):
    bits = lane_bits(x)
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
    COUNTS["ntt_inv_banks_u16" if lane_bits(x) == 16 else "ntt_inv_banks"].plain_calls += 1
    return _inv_banks(x, qs, ninv, ninv_p, itw, itwp, post, postp, negacyclic, lazy,
                      reduce_out)


def _inv_banks(x, qs, ninv, ninv_p, itw, itwp, post, postp, negacyclic, lazy, reduce_out):
    bits = lane_bits(x)
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
    return _weight_mul(x, qs, w, wp, lazy)


def _weight_mul(x, qs, w, wp, lazy):
    nd = x.ndim
    mul = mulmod_shoup_lazy if lazy else mulmod_shoup
    return mul(u32(x), _per_prime(w, nd), _per_prime(wp, nd),
               _per_prime(qs, nd)).int()


_BREV: dict = {}


def brev_index(n: int, device) -> torch.Tensor:
    """Bit-reversal gather index (an involution) for ``n`` on ``device``."""
    key = (n, str(device))
    if key not in _BREV:
        _BREV[key] = torch.from_numpy(bitrev_perm(n)).to(device)
    return _BREV[key]


def fourstep_chain(x, fp: dict, negacyclic: bool, fwd, mul):
    """The four-step forward transform as the reference runs it, a chain
    of bank transforms, weight-row multiplies and PyTorch indexing: the
    psi weights (negacyclic), a transposed copy, pass 1 over the columns,
    its bit-reversal gather, the transpose back, the step-3 twiddle, pass
    2 over the rows, its gather and the readout transpose.  x: (k, B, n);
    fp: FourStepPack of at least k primes; fwd(x, pack, reduce_out) a
    cyclic bank transform with the stage tables of ``pack`` (fp's pack1
    or pack2), mul(x, w, wp) a weight-row multiply, both in one lazy
    mode.  Returns (k, B, n) in natural order (A_hat[k2*n1 + k1]); in lazy
    mode the inter-pass values ride in [0, 2q) and pass 2's epilogue
    restores [0, q)."""
    k, b, n = x.shape
    n1, n2 = fp["pack1"]["tw"].shape[-1] * 2, fp["pack2"]["tw"].shape[-1] * 2
    if negacyclic:
        x = mul(x, fp["psi"][:k], fp["psip"][:k])
    # pass 1: column NTT-N1 units, the N2 columns folded into the batch
    xt = x.reshape(k, b, n1, n2).transpose(-1, -2).reshape(k, b * n2, n1)
    xt = fwd(xt, fp["pack1"], False)[..., brev_index(n1, x.device)]
    x = xt.reshape(k, b, n2, n1).transpose(-1, -2).reshape(k, b, n)
    # step 3: twiddle correction
    x = mul(x, fp["tw"][:k], fp["twp"][:k])
    # pass 2: row NTT-N2 units (epilogue restores the canonical band)
    xr = fwd(x.reshape(k, b * n1, n2), fp["pack2"], True)[..., brev_index(n2, x.device)]
    # readout: A_hat[k2*n1 + k1] = D[k1, k2]
    return xr.reshape(k, b, n1, n2).transpose(-1, -2).reshape(k, b, n)


def ntt_fourstep_banks_ref(x, fp: dict, negacyclic: bool, lazy: bool = False):
    """Four-step forward NTT of x (k, B, n) over FourStepPack ``fp``: the
    reference's chain (``fourstep_chain``) on the plain transforms and
    weight-row multiplies, counted once as ``ntt_fourstep_banks``."""
    COUNTS["ntt_fourstep_banks"].plain_calls += 1
    k = x.shape[0]
    qs = fp["qs"][:k]
    return fourstep_chain(
        x, fp, negacyclic,
        lambda v, t, reduce_out: _fwd_banks(v, qs, t["tw"][:k], t["twp"][:k], None, None,
                                            False, lazy, reduce_out),
        lambda v, w, wp: _weight_mul(v, qs, w, wp, lazy))


def ifourstep_chain(x, fp: dict, negacyclic: bool, inv, mul):
    """The four-step inverse transform as the reference runs it, a chain
    of bank inverses, weight-row multiplies and PyTorch indexing: the
    readout's transposed copy and its bit-reversal gather, the row
    inverses over n2 (lazy epilogue), the inverse step-3 twiddle, a
    transposed copy and its gather, the column inverses over n1, the
    transpose back and (negacyclic) the psi^-i weights, which reduce
    fully (else the column inverses' n1^-1 epilogue does).  x: (k, B, n)
    in natural order (A_hat[k2*n1 + k1]); fp: FourStepPack of at least k
    primes; inv(x, pack, reduce_out) a cyclic bank inverse with the
    stage tables and n^-1 of ``pack`` (fp's pack1 or pack2), mul(x, w,
    wp, reduce) a weight-row multiply, both in one lazy mode and reducing
    fully where their flag says so.  Returns (k, B, n) in [0, q)."""
    k, b, n = x.shape
    n1, n2 = fp["pack1"]["tw"].shape[-1] * 2, fp["pack2"]["tw"].shape[-1] * 2
    # undo the readout: D[k1, k2] from A_hat[k2*n1 + k1]; row iNTT-N2 units
    # (bit-reversed input order)
    xr = x.reshape(k, b, n2, n1).transpose(-1, -2).reshape(k, b * n1, n2)
    xr = inv(xr[..., brev_index(n2, x.device)], fp["pack2"], False)
    # undo the twiddle correction
    x = mul(xr.reshape(k, b, n), fp["itw"][:k], fp["itwp"][:k], False)
    # column iNTT-N1 units
    xt = x.reshape(k, b, n1, n2).transpose(-1, -2).reshape(k, b * n2, n1)
    xt = inv(xt[..., brev_index(n1, x.device)], fp["pack1"], not negacyclic)
    x = xt.reshape(k, b, n2, n1).transpose(-1, -2).reshape(k, b, n)
    if negacyclic:
        x = mul(x, fp["ipsi"][:k], fp["ipsip"][:k], True)
    return x


def intt_fourstep_banks_ref(x, fp: dict, negacyclic: bool, lazy: bool = False):
    """Four-step inverse NTT of x (k, B, n) over FourStepPack ``fp``: the
    reference's chain (``ifourstep_chain``) on the plain inverses and
    weight-row multiplies, counted once as ``intt_fourstep_banks``."""
    COUNTS["intt_fourstep_banks"].plain_calls += 1
    k = x.shape[0]
    qs = fp["qs"][:k]
    return ifourstep_chain(
        x, fp, negacyclic,
        lambda v, t, reduce_out: _inv_banks(v, qs, t["ninv"][:k], t["ninv_p"][:k],
                                            t["itw"][:k], t["itwp"][:k], None, None,
                                            False, lazy, reduce_out),
        lambda v, w, wp, reduce: _weight_mul(v, qs, w, wp, lazy and not reduce))


def dyadic_inner_banks_ref(ext, evk, qs, mus, lazy: bool = False, bits: int = 32):
    """ext: (d, k, B, n), any strides; evk: a key, or a tuple of keys, each
    (d, k, n) shared or (d, k, B, n) per-batch key digits; qs/mus: (k,);
    ``bits`` the moduli's Barrett trait (32, or 23 for ML-DSA's q).
    Digit products accumulated in the kernel's order; one plain call for
    every key, as the kernel is one launch.  Returns a (k, B, n) stack, or
    a tuple of one a key."""
    COUNTS["dyadic_inner_banks"].plain_calls += 1
    q = u32(qs)[:, None, None]
    mu = u32(mus)[:, None, None]
    e = ext.long()

    def inner(evk):
        key = (evk if evk.ndim == 4 else evk[:, :, None, :]).long()
        if lazy:
            acc = mulmod_barrett_lazy(e[0], key[0], q, mu, bits)
            for i in range(1, e.shape[0]):
                acc = lazy_addmod(acc, mulmod_barrett_lazy(e[i], key[i], q, mu, bits), q)
            return torch.where(acc >= q, acc - q, acc).int()
        acc = mulmod_barrett(e[0], key[0], q, mu, bits)
        for i in range(1, e.shape[0]):
            acc = addmod(acc, mulmod_barrett(e[i], key[i], q, mu, bits), q)
        return acc.int()
    return tuple(map(inner, evk)) if isinstance(evk, tuple) else inner(evk)


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


# ------------------------------------------------ RNS base conversions

def extend_centered_ref(ci, src_qs, dst_qs):
    """The key switch's mod-up: digit i of ci (d, ..., n), centred about
    src_qs[i] (a residue above q/2 becomes c - q), reduced onto each of
    the kt dst_qs as ``torch.remainder`` does.  Returns (kt, d, ..., n)."""
    COUNTS["extend_centered"].plain_calls += 1
    c = ci.long()
    sq = u32(src_qs).reshape((-1,) + (1,) * (c.ndim - 1))
    c = torch.where(c > sq // 2, c - sq, c)
    qd = u32(dst_qs).reshape((-1,) + (1,) * c.ndim)
    return torch.remainder(c.unsqueeze(0), qd).int()


def base_conv_ref(x, src, sq, w, wp, cnt, mat, copy, dst):
    """The fast base conversion of hybrid key switching.  x (R, ..., n)
    residue rows; group g's sources are x's rows src[g, i], i < cnt[g],
    with moduli sq[g, i] and premultipliers w[g, i] = (Q_g / q_i)^-1 mod
    q_i (Q_g the product of the group's moduli; wp, their Shoup
    companions, are the kernel's and unread here); mat[g, t, i] = (Q_g /
    q_i) mod dst[t].  Returns (kt, groups, ..., n):

        out[t, g] = sum_i [x_i w_i]_{q_i} mat[g, t, i]  mod dst[t]

    or, where copy[g, t] = i >= 0 (target t is the group's own prime
    q_i), x_i as it is.  Every product and sum is exact in int64, so the
    words are the formula's residues, as the kernel's are."""
    COUNTS["base_conv"].plain_calls += 1
    v = u32(x)
    nd = v.ndim
    groups, slots = src.shape
    kt = dst.shape[0]
    col = lambda t: u32(t).reshape((-1,) + (1,) * (nd - 1))
    p = col(dst)
    out = []
    for g in range(groups):
        m = int(cnt[g])
        rows = v[src[g, :m].long()]                           # (m, ..., n)
        y = rows * col(w[g, :m]) % col(sq[g, :m])
        acc = torch.zeros((kt,) + tuple(v.shape[1:]), dtype=torch.int64, device=v.device)
        for i in range(m):
            acc = (acc + y[i] * col(mat[g, :, i]) % p) % p
        cp = copy[g].long()
        own = (cp >= 0).reshape((-1,) + (1,) * (nd - 1))
        acc = torch.where(own, rows[cp.clamp(min=0)], acc)
        out.append(acc)
    return torch.stack(out, dim=1).int()


def mod_down_tail_ref(acc, extn, qs, pinv, pinv_p, addend=None,
                      batch_leading: bool = False):
    """The mod-down's tail: (acc - extn) * P^-1 mod q_j over (k, B, n)
    stacks, pinv/pinv_p (k,) with Shoup companions; out (k, B, n), or
    (B, k, n) with ``batch_leading``.  ``addend``, in out's layout, is
    added mod q_j to the first addend.shape[batch axis] batch columns."""
    COUNTS["mod_down_tail"].plain_calls += 1
    q = u32(qs)[:, None, None]
    d = submod(acc.long(), extn.long(), q)
    r = mulmod_shoup(d, u32(pinv)[:, None, None], u32(pinv_p)[:, None, None], q)
    if batch_leading:
        r, q = r.transpose(0, 1), q.transpose(0, 1)
    if addend is not None:
        axis = 0 if batch_leading else 1
        head = r.narrow(axis, 0, addend.shape[axis])
        r = torch.cat([addmod(addend.long(), head, q),
                       r.narrow(axis, head.shape[axis], r.shape[axis] - head.shape[axis])],
                      dim=axis)
    return r.int().contiguous()


# ------------------------------------------------------------ Keccak

def _keccak_constants():
    """FIPS 202's round constants (the rc LFSR), rho offsets by lane
    x + 5y, and pi's source lane of each destination lane."""
    rc, r = [], 1
    for _ in range(24):
        c = 0
        for j in range(7):
            if r & 1:
                c |= 1 << ((1 << j) - 1)
            r = ((r << 1) ^ 0x71) if r & 0x80 else (r << 1)
            r &= 0xFF
        rc.append(c)
    rho = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rho[x + 5 * y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return tuple(rc), tuple(rho), tuple(src)


KECCAK_RC, KECCAK_RHO, KECCAK_PI_SRC = _keccak_constants()
_M32 = 0xFFFFFFFF


def _rotl64(lo, hi, r):
    """Rotate 64-bit lanes held as 32-bit halves (int64 tensors below
    2^32) left by r: a (25,) tensor of amounts, or an int."""
    r = torch.as_tensor(r, device=lo.device)
    swap = r >= 32
    lo, hi = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    s = r % 32
    return (((lo << s) | (hi >> (32 - s))) & _M32,
            ((hi << s) | (lo >> (32 - s))) & _M32)


def keccak_f1600_ref(lo, hi):
    """FIPS 202's Keccak-f[1600] on states (..., 25) of 64-bit lanes
    (lane x + 5y) held as low and high 32-bit halves in int64 tensors,
    as the kernel holds them in pairs of registers: torch has no
    unsigned 64-bit shift."""
    dev = lo.device
    rho = torch.tensor(KECCAK_RHO, device=dev)
    pi = torch.tensor(KECCAK_PI_SRC, device=dev)
    for rc in KECCAK_RC:
        a_lo, a_hi = lo.unflatten(-1, (5, 5)), hi.unflatten(-1, (5, 5))   # [y][x]
        c_lo = a_lo[..., 0, :] ^ a_lo[..., 1, :] ^ a_lo[..., 2, :] ^ a_lo[..., 3, :] ^ a_lo[..., 4, :]
        c_hi = a_hi[..., 0, :] ^ a_hi[..., 1, :] ^ a_hi[..., 2, :] ^ a_hi[..., 3, :] ^ a_hi[..., 4, :]
        r_lo, r_hi = _rotl64(c_lo.roll(-1, -1), c_hi.roll(-1, -1), 1)
        d_lo, d_hi = c_lo.roll(1, -1) ^ r_lo, c_hi.roll(1, -1) ^ r_hi
        lo = (a_lo ^ d_lo.unsqueeze(-2)).flatten(-2)
        hi = (a_hi ^ d_hi.unsqueeze(-2)).flatten(-2)
        lo, hi = _rotl64(lo, hi, rho)
        b_lo = lo.index_select(-1, pi).unflatten(-1, (5, 5))
        b_hi = hi.index_select(-1, pi).unflatten(-1, (5, 5))
        lo = (b_lo ^ ((b_lo.roll(-1, -1) ^ _M32) & b_lo.roll(-2, -1))).flatten(-2)
        hi = (b_hi ^ ((b_hi.roll(-1, -1) ^ _M32) & b_hi.roll(-2, -1))).flatten(-2)
        lo[..., 0] ^= rc & _M32
        hi[..., 0] ^= rc >> 32
    return lo, hi


def _lanes(block: torch.Tensor):
    """(S, 8m) byte values -> the (S, m) low and high halves of m lanes."""
    w = block.reshape(block.shape[0], -1, 8) << (8 * torch.arange(8, device=block.device) % 32)
    return w[..., :4].sum(-1), w[..., 4:].sum(-1)


def _lane_bytes(lo, hi):
    """(S, m) lane halves -> their (S, 8m) bytes, little-endian."""
    sh = 8 * torch.arange(4, device=lo.device)
    b = torch.cat([(lo.unsqueeze(-1) >> sh) & 255, (hi.unsqueeze(-1) >> sh) & 255], -1)
    return b.flatten(-2)


def keccak_sponge_ref(data, rate: int, suffix: int, out_len: int):
    """The sponge of Keccak-f[1600] at ``rate`` bytes over each row of
    ``data`` (S, L) bytes (any integer dtype), padded with the domain
    byte ``suffix`` (0x06 SHA3, 0x1F SHAKE) and the final 0x80, squeezing
    ``out_len`` bytes.  Returns (S, out_len) int64 byte values."""
    rows, length = data.shape
    dev = data.device
    blocks = length // rate + 1
    padded = torch.zeros((rows, blocks * rate), dtype=torch.int64, device=dev)
    padded[:, :length] = data.long() & 255
    padded[:, length] ^= suffix
    padded[:, -1] ^= 0x80
    lo = torch.zeros((rows, 25), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    m = rate // 8
    for blk in range(blocks):
        b_lo, b_hi = _lanes(padded[:, blk * rate:(blk + 1) * rate])
        lo[:, :m] ^= b_lo
        hi[:, :m] ^= b_hi
        lo, hi = keccak_f1600_ref(lo, hi)
    out = [_lane_bytes(lo[:, :m], hi[:, :m])]
    while len(out) * rate < out_len:
        lo, hi = keccak_f1600_ref(lo, hi)
        out.append(_lane_bytes(lo[:, :m], hi[:, :m]))
    return torch.cat(out, -1)[:, :out_len]


def keccak_hash_ref(a, b=None, extra=None, *, rate: int, suffix: int, out_len: int):
    """The plain version of ``csrc/keccak.cu`` ``keccak_hash``: the
    sponge over each row a[r] || b[r] || extra ((rows, la) and (rows, lb)
    uint8, ``extra`` one byte or None).  Returns (rows, out_len) uint8."""
    COUNTS["keccak_hash"].plain_calls += 1
    parts = [a] + ([b] if b is not None else [])
    if extra is not None:
        parts.append(torch.full((a.shape[0], 1), extra, dtype=torch.uint8, device=a.device))
    data = torch.cat(parts, -1)
    return keccak_sponge_ref(data, rate, suffix, out_len).to(torch.uint8)


def cg_index(n: int = codec.N, device=None) -> torch.Tensor:
    """CG position of each FIPS 203 NTT index: 2b + p -> (p << 7) | b."""
    f = torch.arange(n, device=device)
    return ((f & 1) << 7) | (f >> 1)


def sample_ntt_ref(rho, transpose: bool):
    """FIPS 203 SampleNTT(rho || j || i) of every row of rho (b, 32) uint8
    and i, j < 3, in CG order, at [r, i, j] (or [r, j, i] with
    ``transpose``): the plain version of ``keccak_sample_ntt``.  Squeezes
    three SHAKE128 blocks, and more for every stream while any stream has
    fewer than 256 candidates below q.  Returns (b, 3, 3, 256) int16."""
    COUNTS["keccak_sample_ntt"].plain_calls += 1
    b = rho.shape[0]
    dev = rho.device
    ij = torch.tensor([[j, i] for i in range(3) for j in range(3)], dtype=torch.uint8,
                      device=dev)
    data = torch.cat([rho.repeat_interleave(9, 0), ij.repeat(b, 1)], -1)
    blocks = 3
    while True:
        buf = keccak_sponge_ref(data, 168, 0x1F, 168 * blocks).reshape(9 * b, -1, 3)
        d1 = buf[..., 0] | ((buf[..., 1] & 15) << 8)
        d2 = (buf[..., 1] >> 4) | (buf[..., 2] << 4)
        cand = torch.stack([d1, d2], -1).flatten(-2)
        ok = cand < codec.Q
        pos = ok.cumsum(-1) - 1
        if int(ok.sum(-1).min()) >= codec.N:
            break
        blocks += 1
    keep = ok & (pos < codec.N)
    fips = torch.zeros((9 * b, codec.N), dtype=torch.int64, device=dev)
    rows = torch.arange(9 * b, device=dev)[:, None].expand_as(pos)
    fips[rows[keep], pos[keep]] = cand[keep]
    out = torch.empty_like(fips)
    out[:, cg_index(device=dev)] = fips
    out = out.reshape(b, 3, 3, codec.N)
    if transpose:
        out = out.transpose(1, 2)
    return out.to(torch.int16).contiguous()


def prf_cbd_ref(seed, n0: int, count: int):
    """CBD_2(PRF_2(seed[r], n0 + c)) for c < count, every row of seed
    (b, 32) uint8: the plain version of ``keccak_prf_cbd``.  Coefficient
    i is nibble i of the 128-byte SHAKE256 stream, (bit0 + bit1) - (bit2
    + bit3) mod q.  Returns (b, count, 256) int16."""
    COUNTS["keccak_prf_cbd"].plain_calls += 1
    b = seed.shape[0]
    dev = seed.device
    nonce = torch.arange(n0, n0 + count, device=dev).to(torch.uint8)[:, None]
    data = torch.cat([seed.repeat_interleave(count, 0), nonce.repeat(b, 1)], -1)
    buf = keccak_sponge_ref(data, 136, 0x1F, 128)
    nib = torch.stack([buf & 15, buf >> 4], -1).flatten(-2)            # (S, 256)
    bit = lambda k: (nib >> k) & 1
    d = bit(0) + bit(1) - bit(2) - bit(3)
    return (d % codec.Q).to(torch.int16).reshape(b, count, codec.N)


# -------------------------------------------------------- ML-KEM codec

def mlkem_decode_check_ref(ek):
    """The plain version of ``csrc/mlkem_codec.cu`` ``mlkem_decode_check``:
    ByteDecode12 of the first 1152 bytes of each row of ek (b, >= 1152)
    uint8 (an encapsulation key's t̂, or a decapsulation key's ŝ) in CG
    order, mod q, and FIPS 203 §7.2's modulus check a row.  Returns
    (t_hat (b, 3, 256) int16, ok (b,) bool)."""
    COUNTS["mlkem_decode_check"].plain_calls += 1
    t = codec.decode12(ek[:, :3 * 384].unflatten(-1, (3, 384)))
    return codec.mod_q(t), (t < codec.Q).flatten(1).all(1)


def mlkem_encaps_tail_ref(u, v, e, m, kr=None, ok=None):
    """The plain version of ``mlkem_encaps_tail``: u + e1 and v + e2 +
    Decompress1(m) mod q (u (b, 3, 256), v (b, 256), e (b, 4, 256) int16:
    e1 then e2; m (b, 32) uint8), Compress10 / Compress4 and ByteEncode10 /
    ByteEncode4 into ct (b, 1088) uint8; with kr (b, >= 32), K = kr[:, :32].
    Rows where ok (b,) bool is False are zeroed.  Returns (K or None, ct)."""
    COUNTS["mlkem_encaps_tail"].plain_calls += 1
    q = codec.Q
    mu = codec.decompress(1, codec.byte_decode(1, m))
    uu = (u.int() + e[:, :3]) % q
    vv = (v.int() + e[:, 3] + mu) % q
    ct = torch.cat([codec.byte_encode(10, codec.compress(10, uu)).flatten(1),
                    codec.byte_encode(4, codec.compress(4, vv))], 1)
    key = None if kr is None else kr[:, :32].contiguous()
    if ok is not None:
        ct = torch.where(ok[:, None], ct, 0)
        key = None if key is None else torch.where(ok[:, None], key, 0)
    return key, ct


# ------------------------------------------------------------ ML-DSA

def _le16(v: torch.Tensor) -> torch.Tensor:
    """(...) integers -> (..., 2) their low two bytes, little-endian."""
    return torch.stack([v & 255, (v >> 8) & 255], -1)


def expand_mask_ref(rho, kappa):
    """FIPS 204 ExpandMask of every row of rho (S, 64) uint8 at its kappa
    (S,) int32: y[s, r] = BitUnpack(SHAKE256(rho[s] || kappa[s] + r, 640),
    gamma1 - 1, gamma1) mod q for r < l, the plain version of
    ``keccak_expand_mask``.  Returns (S, l, 256) int32 residues."""
    COUNTS["keccak_expand_mask"].plain_calls += 1
    rows, dev = rho.shape[0], rho.device
    ell = codec.DSA_L
    nonce = kappa.long()[:, None] + torch.arange(ell, device=dev)
    data = torch.cat([rho.long()[:, None].expand(rows, ell, rho.shape[1]), _le16(nonce)], -1)
    buf = keccak_sponge_ref(data.reshape(rows * ell, -1), 136, 0x1F, 32 * codec.DSA_Z_BITS)
    y = (codec.DSA_GAMMA1 - codec.unpack_bits(buf, codec.DSA_Z_BITS)) % codec.DSA_Q
    return y.reshape(rows, ell, codec.N).int()


def sample_in_ball_ref(ct):
    """FIPS 204 SampleInBall of every row of ct (S, 48) uint8: the plain
    version of ``keccak_sample_in_ball``.  Squeezes one SHAKE256 block a
    row, and another for every row while any row runs out of bytes.
    Returns (S, 256) int32 in {0, 1, q - 1}."""
    COUNTS["keccak_sample_in_ball"].plain_calls += 1
    rows, dev = ct.shape[0], ct.device
    q, n, tau = codec.DSA_Q, codec.N, codec.DSA_TAU
    blocks = 1
    while True:
        buf = keccak_sponge_ref(ct, 136, 0x1F, 136 * blocks)
        sign = (buf[:, :8, None] >> torch.arange(8, device=dev)).flatten(1) & 1
        stream = buf[:, 8:]
        at = torch.arange(stream.shape[1], device=dev)
        pos = torch.zeros(rows, dtype=torch.int64, device=dev)
        c = torch.zeros((rows, n), dtype=torch.int64, device=dev)
        for t, i in enumerate(range(n - tau, n)):
            cand = (stream <= i) & (at >= pos[:, None])
            if not bool(cand.any(1).all()):
                break
            first = cand.long().argmax(1)
            j = stream.gather(1, first[:, None])
            pos = first + 1
            c[:, i] = c.gather(1, j)[:, 0]
            c.scatter_(1, j, torch.where(sign[:, t:t + 1] == 1, q - 1, 1))
        else:
            return c.int()
        blocks += 1


def rej_ntt_poly_ref(rho):
    """FIPS 204 ExpandA of every row of rho (b, 32) uint8: Â[r, s] =
    RejNTTPoly(rho || s || r) (SHAKE128, 3-byte candidates below q), in
    FIPS 204's NTT order, which is the port's; the plain version of
    ``keccak_rej_ntt_poly``.  Returns (b, k, l, 256) int32."""
    COUNTS["keccak_rej_ntt_poly"].plain_calls += 1
    b, dev = rho.shape[0], rho.device
    k, ell, n = codec.DSA_K, codec.DSA_L, codec.N
    sr = torch.tensor([[s, r] for r in range(k) for s in range(ell)], device=dev)
    data = torch.cat([rho.long().repeat_interleave(k * ell, 0), sr.repeat(b, 1)], -1)
    blocks = 5
    while True:
        buf = keccak_sponge_ref(data, 168, 0x1F, 168 * blocks).reshape(b * k * ell, -1, 3)
        cand = buf[..., 0] | (buf[..., 1] << 8) | ((buf[..., 2] & 127) << 16)
        ok = cand < codec.DSA_Q
        if int(ok.sum(-1).min()) >= n:
            break
        blocks += 1
    return _first_taken(cand, ok).reshape(b, k, ell, n)


def _first_taken(cand, ok):
    """(S, m) candidates and their verdicts -> (S, 256) int32: each row's
    first 256 candidates taken, in order."""
    pos = ok.cumsum(-1) - 1
    keep = ok & (pos < codec.N)
    out = torch.zeros((cand.shape[0], codec.N), dtype=torch.int64, device=cand.device)
    rows = torch.arange(cand.shape[0], device=cand.device)[:, None].expand_as(pos)
    out[rows[keep], pos[keep]] = cand[keep]
    return out.int()


def rej_bounded_ref(rho, n0: int, count: int):
    """FIPS 204 RejBoundedPoly(rho[r] || n0 + c) at eta = 4 (SHAKE256,
    half-bytes below 9 taken as 4 - b) for c < count, every row of rho
    (b, 64) uint8: the plain version of ``keccak_rej_bounded``.  Returns
    (b, count, 256) int32 residues mod q."""
    COUNTS["keccak_rej_bounded"].plain_calls += 1
    b, dev = rho.shape[0], rho.device
    nonce = _le16(torch.arange(n0, n0 + count, device=dev))
    data = torch.cat([rho.long().repeat_interleave(count, 0), nonce.repeat(b, 1)], -1)
    blocks = 2
    while True:
        buf = keccak_sponge_ref(data, 136, 0x1F, 136 * blocks)
        half = torch.stack([buf & 15, buf >> 4], -1).flatten(-2)
        ok = half < 9
        if int(ok.sum(-1).min()) >= codec.N:
            break
        blocks += 1
    vals = _first_taken((codec.DSA_ETA - half) % codec.DSA_Q, ok)
    return vals.reshape(b, count, codec.N)


def mu_rho_ref(tr, key, msg, rnd, slots, reqs, count, mu_out, rho_out):
    """The refill hashes of the first ``count`` (a one-element tensor)
    entries of slots / reqs (S,) int64: mu = SHAKE256(tr || msg[req], 64)
    and rho'' = SHAKE256(key || rnd[req] || mu, 64) written to row slot
    of mu_out and rho_out (S + 1, 64) uint8; the plain version of
    ``keccak_mu_rho``.  It hashes every entry and sends those past
    ``count`` to the last row, which takes no slot."""
    COUNTS["keccak_mu_rho"].plain_calls += 1
    s, dev = slots.shape[0], slots.device
    valid = torch.arange(s, device=dev) < count.reshape(())
    req = torch.where(valid, reqs, 0)
    mu = keccak_sponge_ref(torch.cat([tr.expand(s, -1), msg.index_select(0, req)], -1),
                           136, 0x1F, 64).to(torch.uint8)
    rr = keccak_sponge_ref(torch.cat([key.expand(s, -1), rnd.index_select(0, req), mu], -1),
                           136, 0x1F, 64).to(torch.uint8)
    dst = torch.where(valid, slots, mu_out.shape[0] - 1)
    mu_out.index_copy_(0, dst, mu)
    rho_out.index_copy_(0, dst, rr)


def w1_encode_ref(w):
    """w1Encode(HighBits(w)) of w (k, S, 256) int32 residues: (S, 128 k)
    uint8, the plain version of ``mldsa_w1_encode``."""
    COUNTS["mldsa_w1_encode"].plain_calls += 1
    hi = codec.decompose(w)[0].transpose(0, 1)
    return codec.pack_bits(hi, codec.DSA_W1_BITS).flatten(1)


def _z_r_ct0(y, w, cs):
    """z = y + cs1 mod± q (S, l, n); r = w - cs2 mod q and ct0 (S, k, n)."""
    q, ell, k = codec.DSA_Q, codec.DSA_L, codec.DSA_K
    z = codec.centered((y.long() + cs[:ell].transpose(0, 1)) % q)
    r = (w.long() - cs[ell:ell + k]).transpose(0, 1) % q
    return z, r, cs[ell + k:].transpose(0, 1).long()


def _hints(r, ct0):
    """MakeHint(-ct0, r + ct0) = HighBits(r + ct0) != HighBits(r)."""
    return codec.decompose((r + ct0) % codec.DSA_Q)[0] != codec.decompose(r)[0]


def sign_check_ref(y, w, cs, active):
    """FIPS 204 Sign_internal's bounds of every slot: y (S, l, 256), w (k,
    S, 256), cs (l + 2k, S, 256) int32 residues (cs1, cs2, ct0) and
    active (S,) bool.  A slot accepts when active with ||z|| < gamma1 -
    beta, ||r0|| < gamma2 - beta, ||ct0|| < gamma2 and at most omega
    hints; the plain version of ``mldsa_check``.  Returns (S,) bool."""
    COUNTS["mldsa_check"].plain_calls += 1
    z, r, ct0 = _z_r_ct0(y, w, cs)
    r0 = codec.decompose(r)[1]
    return (active & (z.abs().amax((1, 2)) < codec.DSA_GAMMA1 - codec.DSA_BETA)
            & (r0.abs().amax((1, 2)) < codec.DSA_GAMMA2 - codec.DSA_BETA)
            & (codec.centered(ct0).abs().amax((1, 2)) < codec.DSA_GAMMA2)
            & (_hints(r, ct0).sum((1, 2)) <= codec.DSA_OMEGA))


def sign_emit_ref(ct, y, w, cs, dest, ids, kappa, ring, ring_ids, ring_iters):
    """sigEncode(c-tilde, z, h) of every slot whose dest (S,) int64 is
    below R = ring.shape[0] - 1, written to ring[dest] (R + 1, 3309)
    uint8 with its request id (ids, int64) and iterations (kappa / l + 1,
    int32) at ring_ids / ring_iters[dest]; the plain version of
    ``mldsa_emit``.  Slots at R or past it write the last row, which
    holds no entry."""
    COUNTS["mldsa_emit"].plain_calls += 1
    n, k, omega = codec.N, codec.DSA_K, codec.DSA_OMEGA
    z, r, ct0 = _z_r_ct0(y, w, cs)
    h = _hints(r, ct0).flatten(1)
    pos = h.long().cumsum(1) - 1
    hint = torch.zeros((h.shape[0], omega + k), dtype=torch.int64, device=h.device)
    rows, cols = (h & (pos < omega)).nonzero(as_tuple=True)
    hint[rows, pos[rows, cols]] = cols % n
    hint[:, omega:] = h.unflatten(1, (k, n)).sum(-1).cumsum(-1).clamp(max=255)
    sig = torch.cat([ct, codec.pack_bits(codec.DSA_GAMMA1 - z, codec.DSA_Z_BITS).flatten(1),
                     hint.to(torch.uint8)], 1)
    trash = ring.shape[0] - 1
    dst = torch.where(dest < trash, dest, trash)
    ring.index_copy_(0, dst, sig)
    ring_ids.index_copy_(0, dst, ids)
    ring_iters.index_copy_(0, dst, (kappa // codec.DSA_L + 1).int())
