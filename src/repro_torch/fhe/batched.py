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

import numpy as np
import torch

from repro_torch.convert import from_reference
from repro_torch.core.fourstep import make_fourstep_params
from repro_torch.core.modmath import (barrett_precompute, mulmod_shoup,
                                      shoup_precompute, submod, u32)
from repro_torch.core.ntt import cg_intt, cg_ntt
from repro_torch.core.params import fourstep_split, make_ntt_params
from repro_torch.kernels import ops

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
    The pinv rows are basis-relative (P^-1 mod q_j) and left intact."""
    basis_relative = ("pinv", "pinv_p")
    return {k: (v if k in basis_relative else v[rows]) for k, v in t.items()}


def slice_fourstep_pack(fp: dict, rows) -> dict:
    """View of a FourStepPack restricted to prime rows ``rows``."""
    flat = ("qs", "tw", "twp", "itw", "itwp", "psi", "psip", "ipsi", "ipsip")
    return {"pack1": slice_pack(fp["pack1"], rows),
            "pack2": slice_pack(fp["pack2"], rows),
            **{k: fp[k][rows] for k in flat}}


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
    k ``dst_qs``; src_q a 0-d (or 1-element) tensor."""
    c = coeffs.long()
    sq = u32(src_q).reshape(())
    c = torch.where(c > sq // 2, c - sq, c)
    qd = u32(dst_qs).reshape((-1,) + (1,) * c.ndim)
    return torch.remainder(c.unsqueeze(0), qd).int()


def _fwd_banks(x, pack, fpk, lazy):
    return (ops.ntt_fourstep_banks(x, fpk, lazy=lazy) if fpk is not None
            else ops.ntt_banks(x, pack, lazy=lazy))


def _inv_banks(x, pack, fpk, lazy):
    return (ops.intt_fourstep_banks(x, fpk, lazy=lazy) if fpk is not None
            else ops.intt_banks(x, pack, lazy=lazy))


def mod_down_banks(acc, t: dict, *, fsp: dict | None = None, lazy: bool = True):
    """RNS floor by the *last* prime of ``t``'s basis, fully batched — the
    paper's Fig 22 stage 4 (INTT + base-ext + NTT + MS).

    acc: (k+1, B, n) NTT form over t's k+1 primes; returns (k, B, n) over
    the first k.  Serves both the key-switch mod-down by the special
    prime P and the ciphertext rescale by q_l.  ``fsp`` routes every
    transform through the four-step pipeline."""
    k = acc.shape[0] - 1
    fs_last = slice_fourstep_pack(fsp, slice(k, k + 1)) if fsp is not None else None
    lastc = _inv_banks(acc[k:], slice_pack(t, slice(k, k + 1)), fs_last, lazy)
    ext = extend_centered(lastc[0], t["qs"][k], t["qs"][:k])
    extn = _fwd_banks(ext, slice_pack(t, slice(0, k)), fsp, lazy)
    qcol = u32(t["qs"][:k])[:, None, None]
    d = submod(acc[:k].long(), extn.long(), qcol)
    return mulmod_shoup(d, u32(t["pinv"])[:, None, None],
                        u32(t["pinv_p"])[:, None, None], qcol).int()


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
    (d, kt, B, n): NTT-domain digit extensions, digit axis first."""
    ext = torch.stack([extend_centered(ci[i], src_qs[i], t["qs"])
                       for i in range(ci.shape[0])])            # (d, kt, B, n)
    # NTT banks: the digit axis folds into the batch
    y = _fwd_banks(ext.transpose(0, 1), t, fsp, lazy)           # (kt, d, B, n)
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
                     fsp: dict | None = None, lazy: bool = True):
    """The key switch from the coefficient digits on: ``decompose_extend``
    onto t's kt primes (the last the special P), the two digit MACs and
    the mod-downs by P.  ci: (d, B, n) digits mod ``src_qs``; evk_b/evk_a:
    (d, kt, n) or (d, kt, B, n) key digits over t's primes.  Returns
    (ks0, ks1): (kt - 1, B, n)."""
    y = decompose_extend(ci, src_qs, t, fsp=fsp, lazy=lazy)    # (digit, prime, B, n)
    acc0 = ops.dyadic_inner_banks(y, evk_b, t, lazy=lazy)       # MM/MA arrays
    acc1 = ops.dyadic_inner_banks(y, evk_a, t, lazy=lazy)
    return (mod_down_banks(acc0, t, fsp=fsp, lazy=lazy),
            mod_down_banks(acc1, t, fsp=fsp, lazy=lazy))


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
