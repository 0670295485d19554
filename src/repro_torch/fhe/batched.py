"""Table packs and the batched key switch (paper Fig 22) over the banks.

Table pack layout for a basis of ``k`` primes over ring n (int32 tensors
holding uint32 values):
  qs      (k,)           prime moduli
  tw/twp  (k, s, n/2)    forward CG twiddles + Shoup companions
  itw/itwp(k, s, n/2)    inverse
  ninv/ninv_p (k,)       n^-1 per prime
  psi/psip, ipsin/ipsinp (k, n)  negacyclic weights (ipsin folds n^-1)
  mu      (k,)           Barrett constants (dyadic ct x ct products)
  pinv/pinv_p (k-1,)     P^-1 mod q_j, the last prime being P

FourStepPack layout for large N = N1*N2:
  qs        (k,)         prime moduli
  pack1     TablePack for the N1 column transform (psi^N2)
  pack2     TablePack for the N2 row transform (psi^N1)
  tw/twp    (k, n)       step-3 twiddle w^(j2*k1), flattened [k1*N2 + j2]
  itw/itwp  (k, n)       its inverse
  psi/psip  (k, n)       negacyclic psi^i pre-weights (natural order)
  ipsi/ipsip(k, n)       psi^-i post-weights (no n^-1 fold)

The host builders return uint32 numpy dicts (``*_np``); the device forms
come from ``convert.from_reference`` on them, so a pack moved across
from the reference and one built here are the same tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.convert import from_reference
from repro_torch.core.fourstep import make_fourstep_params
from repro_torch.core.modmath import (barrett_precompute, mulmod_shoup,
                                      shoup_precompute, u32)
from repro_torch.core.ntt import cg_intt, cg_ntt
from repro_torch.core.params import fourstep_split, make_ntt_params
from repro_torch.kernels import basis_kernel, ops

_PACK_KEYS = ("qs", "tw", "twp", "itw", "itwp", "ninv", "ninv_p", "psi",
              "psip", "ipsin", "ipsinp", "mu")


@dataclasses.dataclass
class TablePack:
    """The TablePack layout as named fields (int32 tensors of uint32
    values); ``tree()`` is the dict form the banks entry points take."""
    qs: torch.Tensor
    tw: torch.Tensor
    twp: torch.Tensor
    itw: torch.Tensor
    itwp: torch.Tensor
    ninv: torch.Tensor
    ninv_p: torch.Tensor
    psi: torch.Tensor
    psip: torch.Tensor
    ipsin: torch.Tensor
    ipsinp: torch.Tensor
    mu: torch.Tensor

    def tree(self) -> dict:
        return dataclasses.asdict(self)


def table_pack_shapes(k: int, n: int) -> dict:
    """The shapes of a k-prime TablePack over ring n, pinv rows included,
    as tensors on the ``meta`` device (shape and dtype, no data): what a
    dry run sizes the packs by."""
    s = n.bit_length() - 1
    shapes = {
        "qs": (k,), "tw": (k, s, n // 2), "twp": (k, s, n // 2),
        "itw": (k, s, n // 2), "itwp": (k, s, n // 2),
        "ninv": (k,), "ninv_p": (k,),
        "psi": (k, n), "psip": (k, n), "ipsin": (k, n), "ipsinp": (k, n),
        "mu": (k,),
        # P^-1 mod q_j (the last prime is the special P), Shoup companions
        "pinv": (max(k - 1, 1),), "pinv_p": (max(k - 1, 1),),
    }
    return {name: torch.empty(shape, dtype=torch.int32, device="meta")
            for name, shape in shapes.items()}


def pack_from_ntt_params(params: list) -> dict:
    """Stack per-prime ``NTTParams`` rows into the TablePack layout (numpy
    uint32).  The pinv rows treat the last prime as the special P."""
    rows = {k: [] for k in _PACK_KEYS}
    primes = [p.q for p in params]
    for p in params:
        rows["qs"].append(np.uint32(p.q))
        rows["tw"].append(p.tw)
        rows["twp"].append(p.twp)
        rows["itw"].append(p.itw)
        rows["itwp"].append(p.itwp)
        rows["ninv"].append(np.uint32(p.ninv))
        rows["ninv_p"].append(np.uint32(p.ninv_p))
        rows["psi"].append(p.psi_pows)
        rows["psip"].append(p.psi_pows_p)
        rows["ipsin"].append(p.ipsi_ninv)
        rows["ipsinp"].append(p.ipsi_ninv_p)
        rows["mu"].append(np.uint32(barrett_precompute(p.q)))
    out = {k: np.stack(v) for k, v in rows.items()}
    out["pinv"], out["pinv_p"] = _pinv_rows(primes)
    return out


def _pinv_rows(primes) -> tuple[np.ndarray, np.ndarray]:
    """P^-1 mod q_j rows (last prime = the special P) + Shoup companions."""
    P = primes[-1]
    src = primes[:-1] if len(primes) > 1 else primes
    pinv = np.array([pow(P, -1, q) if q != P else 1 for q in src],
                    dtype=np.uint32)
    pinv_p = np.array([shoup_precompute(int(v), q)
                       for v, q in zip(pinv, src)], dtype=np.uint32)
    return pinv, pinv_p


@functools.lru_cache(maxsize=None)
def table_pack_np(primes: tuple[int, ...], n: int) -> dict:
    return pack_from_ntt_params([make_ntt_params(n, q=q) for q in primes])


def build_table_pack(primes, n: int, device) -> dict:
    """TablePack for a prime basis over ring n, as tensors on ``device``."""
    return from_reference(table_pack_np(tuple(primes), n), device)


def build_scalar_pack(primes, device) -> dict:
    """Just the per-prime scalar rows of a TablePack (qs/mu/pinv/pinv_p):
    the four-step key switch never reads the size-n tables of ``t``."""
    primes = list(primes)
    qs = np.array(primes, dtype=np.uint32)
    mu = np.array([barrett_precompute(q) for q in primes], dtype=np.uint32)
    pinv, pinv_p = _pinv_rows(primes)
    return from_reference({"qs": qs, "mu": mu, "pinv": pinv, "pinv_p": pinv_p},
                          device)


def fourstep_pack_from_params(fsps: list) -> dict:
    """Stack per-prime ``FourStepParams`` into the FourStepPack layout
    (numpy uint32)."""
    def flat(name):
        return np.stack([np.asarray(getattr(f, name)).reshape(-1) for f in fsps])

    return {
        "qs": np.array([f.q for f in fsps], dtype=np.uint32),
        "pack1": pack_from_ntt_params([f.p1 for f in fsps]),
        "pack2": pack_from_ntt_params([f.p2 for f in fsps]),
        "tw": flat("tw_mat"), "twp": flat("tw_mat_p"),
        "itw": flat("itw_mat"), "itwp": flat("itw_mat_p"),
        "psi": flat("psi_mat"), "psip": flat("psi_mat_p"),
        "ipsi": flat("ipsi_mat"), "ipsip": flat("ipsi_mat_p"),
    }


@functools.lru_cache(maxsize=None)
def fourstep_pack_np(primes: tuple[int, ...], n: int) -> dict:
    n1, n2 = fourstep_split(n)
    return fourstep_pack_from_params(
        [make_fourstep_params(n1, n2, q) for q in primes])


def build_fourstep_pack(primes, n: int, device) -> dict:
    """FourStepPack for a prime basis over ring n (balanced split), as
    tensors on ``device``."""
    return from_reference(fourstep_pack_np(tuple(primes), n), device)


def slice_pack(t: dict, rows) -> dict:
    """View of a TablePack restricted to prime rows ``rows`` (a slice).
    The pinv rows are basis-relative (P^-1 mod q_j) and left intact, as
    is a hybrid pack's ``conv``."""
    basis_relative = ("pinv", "pinv_p", "conv")
    return {k: (v if k in basis_relative else v[rows]) for k, v in t.items()}


def slice_fourstep_pack(fp: dict, rows) -> dict:
    """View of a FourStepPack restricted to prime rows ``rows``."""
    flat = ("qs", "tw", "twp", "itw", "itwp", "psi", "psip", "ipsi", "ipsip")
    return {"pack1": slice_pack(fp["pack1"], rows),
            "pack2": slice_pack(fp["pack2"], rows),
            **{k: fp[k][rows] for k in flat}}


# ------------------------------------------------ hybrid key switching

def conv_table_np(groups, dst) -> dict:
    """The table of a fast base conversion (``ops.base_conv_banks``), in
    numpy uint32: ``groups`` lists, per group, its sources as (row, q)
    pairs (the row of the input that holds the residues mod q); ``dst``
    the kt target primes.  Per group g of product Q_g and source i:
    w = (Q_g/q_i)^-1 mod q_i with its Shoup companion, and per target t,
    mat = (Q_g/q_i) mod dst[t] and copy = i where dst[t] is q_i itself
    (else -1).  A group of fewer sources than the stride is padded with
    its first source and zero weights."""
    dst = [int(p) for p in dst]
    size = max(len(g) for g in groups)
    slots = next((s for s in basis_kernel.SLOTS if s >= size), None)
    if slots is None:
        raise ValueError(f"conv_table_np: {size} sources a group; at most "
                         f"{basis_kernel.SLOTS[-1]}")
    G, kt = len(groups), len(dst)
    src = np.zeros((G, slots), dtype=np.int64)
    sq = np.ones((G, slots), dtype=np.int64)
    w = np.zeros((G, slots), dtype=np.int64)
    wp = np.zeros((G, slots), dtype=np.int64)
    mat = np.zeros((G, kt, slots), dtype=np.int64)
    copy = np.full((G, kt), -1, dtype=np.int64)
    for g, group in enumerate(groups):
        Qg = math.prod(q for _, q in group)
        src[g] = group[0][0]
        sq[g] = group[0][1]
        for i, (row, q) in enumerate(group):
            hat = Qg // q
            src[g, i], sq[g, i] = row, q
            w[g, i] = pow(hat % q, -1, q)
            wp[g, i] = shoup_precompute(int(w[g, i]), q)
            mat[g, :, i] = [hat % p for p in dst]
            copy[g, [t for t, p in enumerate(dst) if p == q]] = i
    u = lambda a: (a & 0xFFFFFFFF).astype(np.uint32)       # copy's -1 as 0xFFFFFFFF
    return {"src": u(src), "sq": u(sq), "w": u(w), "wp": u(wp),
            "cnt": np.array([len(g) for g in groups], dtype=np.uint32),
            "mat": u(mat), "copy": u(copy), "dst": np.array(dst, dtype=np.uint32)}


def key_digits(basis, alpha: int) -> list[tuple[int, ...]]:
    """The key-switch digits of a basis: consecutive runs of ``alpha``
    primes, the last possibly shorter."""
    basis = tuple(basis)
    return [basis[i:i + alpha] for i in range(0, len(basis), alpha)]


@functools.lru_cache(maxsize=None)
def hybrid_pack_np(basis: tuple[int, ...], specials: tuple[int, ...], alpha: int) -> dict:
    """What a key switch at ``basis`` needs besides the TablePack of
    basis + specials under hybrid key switching (numpy uint32):
      conv.up    the mod-up: digit j (the rows j alpha ... of the
                 coefficient stack) onto basis + specials
      conv.down  the mod-down's conversion of the K special rows onto
                 the basis
      pinv/pinv_p  P^-1 mod q_j for P the product of the specials, with
                 Shoup companions (in place of the TablePack's, which
                 divide by one prime)"""
    full = tuple(basis) + tuple(specials)
    up = conv_table_np([[(j * alpha + i, q) for i, q in enumerate(d)]
                        for j, d in enumerate(key_digits(basis, alpha))], full)
    down = conv_table_np([list(enumerate(specials))], basis)
    P = math.prod(specials)
    pinv = np.array([pow(P, -1, q) for q in basis], dtype=np.uint32)
    pinv_p = np.array([shoup_precompute(int(v), q) for v, q in zip(pinv, basis)],
                      dtype=np.uint32)
    return {"conv": {"up": up, "down": down}, "pinv": pinv, "pinv_p": pinv_p}


def build_hybrid_pack(basis, specials, alpha: int, device) -> dict:
    """``hybrid_pack_np`` as tensors on ``device``: merged into the key
    switch's table pack ``t``, it routes ``decompose_extend`` and
    ``mod_down_banks`` through the fast base conversion."""
    return from_reference(hybrid_pack_np(tuple(basis), tuple(specials), alpha), device)


# ------------------------------------------------ per-prime primitives

def ntt_fwd_i(x, t: dict, i):
    """Negacyclic forward NTT of x (..., n) under prime row i of the pack
    (bit-reversed order out)."""
    q = u32(t["qs"][i])
    x = mulmod_shoup(u32(x), u32(t["psi"][i]), u32(t["psip"][i]), q)
    return cg_ntt(x, t["tw"][i], t["twp"][i], q)


def ntt_inv_i(x, t: dict, i):
    """Inverse of ``ntt_fwd_i`` (n^-1 folded into the psi^-i weights)."""
    q = u32(t["qs"][i])
    x = cg_intt(x, t["itw"][i], t["itwp"][i], 0, 0, q, apply_ninv=False)
    return mulmod_shoup(u32(x), u32(t["ipsin"][i]), u32(t["ipsinp"][i]), q).int()


# ---------------------------------------------------------- keyswitch

def extend_centered(coeffs, src_q, dst_qs):
    """EXACT single-prime base conversion (alpha=1 mod-up).
    coeffs: (..., n) int32 mod src_q -> (k, ..., n) int32 mod each of the
    k ``dst_qs``; src_q a 0-d (or 1-element) tensor.  One digit of
    ``ops.extend_centered_banks``."""
    return ops.extend_centered_banks(coeffs[None], src_q.reshape(1), dst_qs)[:, 0]


def _fwd_banks(x, pack, fpk, lazy):
    return (ops.ntt_fourstep_banks(x, fpk, lazy=lazy) if fpk is not None
            else ops.ntt_banks(x, pack, lazy=lazy))


def _inv_banks(x, pack, fpk, lazy):
    return (ops.intt_fourstep_banks(x, fpk, lazy=lazy) if fpk is not None
            else ops.intt_banks(x, pack, lazy=lazy))


def mod_down_banks(acc, t: dict, *, fsp: dict | None = None, lazy: bool = True,
                   addend=None, batch_leading: bool = False):
    """RNS floor by the *last* prime of ``t``'s basis, fully batched — the
    paper's Fig 22 stage 4 (INTT + base-ext + NTT + MS).

    acc: (k+1, B, n) NTT form over t's k+1 primes; returns (k, B, n) over
    the first k, or (B, k, n) with ``batch_leading``.  Serves both the
    key-switch mod-down by the special prime P and the ciphertext rescale
    by q_l.  ``fsp`` routes every transform through the four-step
    pipeline.  ``addend`` (in the output's layout, over its first batch
    columns) is added mod q_j inside the tail, as ``ops.mod_down_tail_banks``
    takes it.

    A hybrid pack (``t["conv"]``, from ``build_hybrid_pack``) divides by
    the product P of its K special primes, the last K rows of acc
    instead: (acc_Q - Conv_{P->Q}(acc_P)) * P^-1 mod q_j, the K rows'
    iNTT converted onto the k others by ``ops.base_conv_banks``."""
    down = t["conv"]["down"] if "conv" in t else None
    k = acc.shape[0] - 1 if down is None else down["dst"].shape[0]
    rows = slice(k, acc.shape[0])
    fs_last = slice_fourstep_pack(fsp, rows) if fsp is not None else None
    lastc = _inv_banks(acc[k:], slice_pack(t, rows), fs_last, lazy)
    if down is None:
        ext = ops.extend_centered_banks(lastc, t["qs"][k:k + 1], t["qs"][:k])[:, 0]
    else:
        ext = ops.base_conv_banks(lastc, down)[:, 0]
    extn = _fwd_banks(ext, slice_pack(t, slice(0, k)), fsp, lazy)
    return ops.mod_down_tail_banks(acc, extn, t, addend=addend,
                                   batch_leading=batch_leading)


def decompose_intt(d2, t: dict, *, fsp: dict | None = None, lazy: bool = True):
    """Phase (A) of the digit decomposition: the digit iNTTs (Fig 22's
    INTT units), one per prime row.

    d2: (k, B, n) NTT form over t's first k primes.  Returns the (k, B, n)
    coefficient digits, digit i mod t's prime i."""
    k = d2.shape[0]
    return _inv_banks(d2, slice_pack(t, slice(0, k)), fsp, lazy)


def decompose_extend(ci, src_qs, t: dict, *, fsp: dict | None = None,
                     lazy: bool = True):
    """Phase (B): the centered extension of every coefficient digit onto
    t's primes, then the forward banks (Fig 22's base extension and NTT
    banks).  The one step of a key switch that reads every prime's digit.

    ci: (d, B, n) coefficient digits, digit i mod ``src_qs[i]`` (which
    need not be t's primes: a "k" shard extends every digit onto its own
    block); t: the pack of the kt primes extended onto.  Returns
    (d, kt, B, n): NTT-domain digit extensions, digit axis first.

    Under a hybrid pack (``t["conv"]``) ci is the (k, B, n) coefficient
    stack of the basis instead, and each digit of alpha primes is
    converted onto the kt primes by the fast base conversion."""
    if "conv" in t:
        ext = ops.base_conv_banks(ci, t["conv"]["up"])            # (kt, d, B, n)
    else:
        ext = ops.extend_centered_banks(ci, src_qs, t["qs"])     # (kt, d, B, n)
    # NTT banks: the digit axis folds into the batch
    y = _fwd_banks(ext, t, fsp, lazy)                           # (kt, d, B, n)
    return y.transpose(0, 1)                                    # (digit, prime, B, n)


def decompose_banks(d2, t: dict, *, fsp: dict | None = None, lazy: bool = True):
    """RNS digit decomposition + mod-up — the front half of Fig 22 (INTT
    units -> base extension -> NTT banks): ``decompose_extend`` of
    ``decompose_intt``.

    d2: (k, B, n) NTT form over the k-prime basis; t: pack for k+1 primes
    (row k = the special prime P).  Returns (k, k+1, B, n): NTT-domain
    digit extensions, digit axis first."""
    ci = decompose_intt(d2, t, fsp=fsp, lazy=lazy)
    return decompose_extend(ci, t["qs"], t, fsp=fsp, lazy=lazy)


def keyswitch_digits(ci, src_qs, evk_b, evk_a, t: dict, *,
                     fsp: dict | None = None, lazy: bool = True, add0=None,
                     add1=None, batch_leading: bool = False):
    """The key switch from the coefficient digits on: ``decompose_extend``
    onto t's kt primes (the last the special P, or P's K primes under a
    hybrid pack), the two digit MACs (one launch) and the mod-downs by P.  ci: (d, B, n) digits mod ``src_qs``; evk_b/evk_a:
    (d, kt, n) or (d, kt, B, n) key digits over t's primes.  Returns
    (ks0, ks1): (kt - 1, B, n), or (B, kt - 1, n) with ``batch_leading``;
    ``add0``/``add1`` (in that layout) are added to them mod q_j inside
    the mod-downs' tails."""
    y = decompose_extend(ci, src_qs, t, fsp=fsp, lazy=lazy)    # (digit, prime, B, n)
    # MM/MA arrays: both key halves in one launch, y read in place
    acc0, acc1 = ops.dyadic_inner_banks(y, (evk_b, evk_a), t, lazy=lazy)
    return (mod_down_banks(acc0, t, fsp=fsp, lazy=lazy, addend=add0,
                           batch_leading=batch_leading),
            mod_down_banks(acc1, t, fsp=fsp, lazy=lazy, addend=add1,
                           batch_leading=batch_leading))


def batched_keyswitch(d2, evk_b, evk_a, t: dict, *, fsp: dict | None = None,
                      lazy: bool = True):
    """Paper Fig 22 pipeline, vectorized over a ciphertext batch and the
    RNS prime rows: ``keyswitch_digits`` of ``decompose_intt``.

    d2:      (k, B, n) NTT form over the k-prime basis
    evk_b/a: (k, k+1, n) key digits over basis + special, shared by the
             batch, or (k, k+1, B, n) per batch row
    t:       pack for k+1 primes (row k = the special prime P); with
             ``fsp`` (a FourStepPack for the same primes) every transform
             runs the four-step pipeline and t may be the scalar pack.
    Returns (ks0, ks1): (k, B, n) over the original basis."""
    ci = decompose_intt(d2, t, fsp=fsp, lazy=lazy)
    return keyswitch_digits(ci, t["qs"], evk_b, evk_a, t, fsp=fsp, lazy=lazy)
