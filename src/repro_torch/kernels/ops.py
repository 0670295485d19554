"""Entry points of the NTT/dyadic compute layer over multi-prime banks.

Every function takes a TablePack / FourStepPack dict of int32 tensors
(see ``fhe.batched``) whose per-prime rows are stacked on axis 0 — the
paper's Fig 22 parallel NTT-bank array — and dispatches to a kernel
wrapper, which launches the Hopper kernel for a CUDA tensor and runs the
plain version for a CPU tensor.

Ciphertext-batch axis convention: the banks entry points also accept
``batch_leading=True``, meaning the input is a ``(b, k, ..., n)`` stack
of ``b`` polynomials over the same k-prime basis; the leading axis is
swapped behind the prime axis, folded into the kernel batch, and
swapped back on the way out.

Below ``FOURSTEP_MIN_N`` the whole transform is one banks kernel and
NTT rows are in bit-reversed order; at and above it the four-step
pipeline runs (two bank passes of n1- and n2-point transforms with the
step-3 twiddle multiply between them) and NTT rows are in natural order.
The four-step transposes and bit-reversal gathers are torch indexing, as
they sit outside the kernels in the reference too.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.params import bitrev_perm
from repro_torch.kernels import dyadic_kernel, ntt_kernel

FOURSTEP_MIN_N = 1 << 13


def _rows(t: dict, k: int, *names):
    """First-k prime rows of the named pack entries (so a pack for a
    superset basis, e.g. basis + special, works on k-row inputs)."""
    return tuple(t[name][:k] for name in names)


def _ct_batch_axis(fn):
    """``batch_leading=True`` reads the first argument as a (b, k, ..., n)
    stack: swap the ciphertext axis behind the prime axis, run the
    prime-major path, swap the output back."""
    @functools.wraps(fn)
    def wrapper(x, *args, batch_leading: bool = False, **kw):
        if batch_leading:
            return fn(x.transpose(0, 1), *args, **kw).transpose(0, 1)
        return fn(x, *args, **kw)
    return wrapper


def _as3(x: torch.Tensor) -> torch.Tensor:
    """(k, ..., n) -> contiguous (k, B, n) view for a kernel wrapper."""
    return x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()


@_ct_batch_axis
def ntt_banks(x, t: dict, *, negacyclic: bool = True, lazy: bool = True,
              reduce_out: bool = True):
    """Batched multi-prime forward NTT.  x: (k, ..., n) int32, row i
    reduced mod t['qs'][i]; t: TablePack for (at least) those k primes.
    ``lazy`` keeps butterflies in [0, 2q); ``reduce_out=False`` (lazy
    only) hands the raw [0, 2q) representatives to a lazy-aware
    consumer.  Output in bit-reversed order."""
    k = x.shape[0]
    qs, tw, twp, psi, psip = _rows(t, k, "qs", "tw", "twp", "psi", "psip")
    out = ntt_kernel.ntt_fwd_banks(_as3(x), qs, tw, twp, psi, psip,
                                   negacyclic=negacyclic, lazy=lazy,
                                   reduce_out=reduce_out)
    return out.reshape(x.shape)


@_ct_batch_axis
def intt_banks(x, t: dict, *, negacyclic: bool = True, lazy: bool = True,
               reduce_out: bool = True):
    k = x.shape[0]
    qs, ninv, ninv_p, itw, itwp, ipsin, ipsinp = _rows(
        t, k, "qs", "ninv", "ninv_p", "itw", "itwp", "ipsin", "ipsinp")
    out = ntt_kernel.ntt_inv_banks(_as3(x), qs, ninv, ninv_p, itw, itwp,
                                   ipsin, ipsinp, negacyclic=negacyclic,
                                   lazy=lazy, reduce_out=reduce_out)
    return out.reshape(x.shape)


@_ct_batch_axis
def twiddle_mul_banks(x, w, wp, qs, *, lazy: bool = False):
    """Per-prime weight-row multiply: x (k, ..., n), w/wp (k, n), qs (k,).
    The four-step step-3 twiddle and the negacyclic psi weights.  Any
    input representative; ``lazy`` emits the [0, 2q) one."""
    out = ntt_kernel.twiddle_mul_banks(_as3(x), qs, w, wp, lazy=lazy)
    return out.reshape(x.shape)


_BREV: dict = {}


def _brev(n: int, device) -> torch.Tensor:
    """Bit-reversal gather index (an involution) for ``n`` on ``device``."""
    key = (n, str(device))
    if key not in _BREV:
        _BREV[key] = torch.from_numpy(bitrev_perm(n)).to(device)
    return _BREV[key]


def fourstep_dims(fp: dict) -> tuple[int, int]:
    """(n1, n2) of a four-step pack, read from its table shapes."""
    return fp["pack1"]["tw"].shape[-1] * 2, fp["pack2"]["tw"].shape[-1] * 2


@_ct_batch_axis
def ntt_fourstep_banks(x, fp: dict, *, negacyclic: bool = True,
                       lazy: bool = True):
    """Large-N forward NTT via the four-step decomposition, every pass on
    the bank kernels (paper §IX).  x: (k, ..., n); fp: FourStepPack for at
    least those k primes.  Output in natural frequency order
    (A_hat[k2*n1 + k1]).  In lazy mode the inter-pass values ride in
    [0, 2q) and pass 2's epilogue restores [0, q)."""
    k = x.shape[0]
    n1, n2 = fourstep_dims(fp)
    n = n1 * n2
    if x.shape[-1] != n:
        raise ValueError(f"ntt_fourstep_banks: rows of {x.shape[-1]} for a "
                         f"{n1}x{n2} pack")
    qs = fp["qs"][:k]
    shape = x.shape
    x = x.reshape(k, -1, n)
    b = x.shape[1]
    if negacyclic:
        x = twiddle_mul_banks(x, fp["psi"][:k], fp["psip"][:k], qs, lazy=lazy)
    # pass 1: column NTT-N1 units, the N2 columns folded into the batch
    xt = x.reshape(k, b, n1, n2).transpose(-1, -2).reshape(k, b * n2, n1)
    xt = ntt_banks(xt, fp["pack1"], negacyclic=False, lazy=lazy,
                   reduce_out=False)[..., _brev(n1, x.device)]
    x = xt.reshape(k, b, n2, n1).transpose(-1, -2).reshape(k, b, n)
    # step 3: twiddle correction
    x = twiddle_mul_banks(x, fp["tw"][:k], fp["twp"][:k], qs, lazy=lazy)
    # pass 2: row NTT-N2 units (epilogue restores the canonical band)
    xr = x.reshape(k, b * n1, n2)
    xr = ntt_banks(xr, fp["pack2"], negacyclic=False,
                   lazy=lazy)[..., _brev(n2, x.device)]
    # readout: A_hat[k2*n1 + k1] = D[k1, k2]
    return xr.reshape(k, b, n1, n2).transpose(-1, -2).reshape(shape)


@_ct_batch_axis
def intt_fourstep_banks(x, fp: dict, *, negacyclic: bool = True,
                        lazy: bool = True):
    """Inverse of ``ntt_fourstep_banks`` (natural-order input).  The two
    sub-iNTT passes contribute 1/N1 * 1/N2; the final multiply (psi^-i,
    or pass 1's ninv epilogue) fully reduces."""
    k = x.shape[0]
    n1, n2 = fourstep_dims(fp)
    n = n1 * n2
    if x.shape[-1] != n:
        raise ValueError(f"intt_fourstep_banks: rows of {x.shape[-1]} for a "
                         f"{n1}x{n2} pack")
    qs = fp["qs"][:k]
    shape = x.shape
    x = x.reshape(k, -1, n)
    b = x.shape[1]
    # undo the readout: D[k1, k2] from A_hat[k2*n1 + k1]
    x = x.reshape(k, b, n2, n1).transpose(-1, -2)
    # inverse pass 2: row iNTT-N2 banks (bitrev input order)
    xr = x.reshape(k, b * n1, n2)[..., _brev(n2, x.device)]
    xr = intt_banks(xr, fp["pack2"], negacyclic=False, lazy=lazy,
                    reduce_out=False)
    # undo the twiddle correction
    x = twiddle_mul_banks(xr.reshape(k, b, n), fp["itw"][:k], fp["itwp"][:k],
                          qs, lazy=lazy)
    # inverse pass 1: column iNTT-N1 banks
    xt = (x.reshape(k, b, n1, n2).transpose(-1, -2)
          .reshape(k, b * n2, n1)[..., _brev(n1, x.device)])
    xt = intt_banks(xt, fp["pack1"], negacyclic=False, lazy=lazy,
                    reduce_out=not negacyclic)
    x = xt.reshape(k, b, n2, n1).transpose(-1, -2).reshape(k, b, n)
    if negacyclic:
        x = twiddle_mul_banks(x, fp["ipsi"][:k], fp["ipsip"][:k], qs)  # full reduce
    return x.reshape(shape)


def dyadic_inner_banks(ext, evk, t: dict, *, lazy: bool = True):
    """Key-switch inner product out[j] = sum_i ext[i, j] * evk[i, j] mod q_j.
    ext: (d, k, B, n) NTT-domain digit extensions; evk: (d, k, n) shared
    or (d, k, B, n) per-batch key digits; t: pack whose rows align with
    axis 1."""
    if ext.ndim != 4 or evk.ndim not in (3, 4) or ext.shape[1] != t["qs"].shape[0]:
        raise ValueError(f"dyadic_inner_banks: ext {tuple(ext.shape)}, evk "
                         f"{tuple(evk.shape)} for {t['qs'].shape[0]} primes")
    if evk.ndim == 4 and evk.shape != ext.shape:
        raise ValueError(f"dyadic_inner_banks: per-batch evk {tuple(evk.shape)} "
                         f"!= ext {tuple(ext.shape)}")
    return dyadic_kernel.dyadic_inner_banks(ext.contiguous(), evk.contiguous(),
                                            t["qs"], t["mu"], lazy=lazy)
