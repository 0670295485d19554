"""Wrappers of the Galois gather kernels (``csrc/galois.cu``).

``galois_banks`` / ``galois_banks_multi`` / ``galois_digits`` replace the
TPU kernels ``galois_banks_pallas`` / ``galois_banks_multi_pallas`` /
``galois_digits_pallas`` of the reference's ``kernels/galois_kernel.py``:
the NTT-domain automorphism as a lane gather, with one shared index row,
one per batch element, or one per batch element applied to every digit
of a key-switch decomposition.  A CPU tensor goes to the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises.  The block
stages one source row in shared memory and moves rows as 16-byte
vectors, so a row longer than a block's shared memory holds, a row
length that is not a multiple of 4 and a tensor not 16-byte aligned are
refused with ``ValueError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, build, ref
from repro_torch.kernels.ntt_kernel import (check_shape, check_tensors,
                                            raise_on, stream)

MAX_ROW = 232448 // 4     # words of one row in a block's 227 KB of shared memory


def _check_row(where: str, n: int, rows: int) -> None:
    if n > MAX_ROW:
        raise ValueError(f"{where}: a row of n={n} words exceeds the {MAX_ROW} "
                         "words one block's shared memory holds")
    if n % 4:
        raise ValueError(f"{where}: rows move as 16-byte vectors, so n={n} "
                         "must be a multiple of 4")
    if rows >= 1 << 31:
        raise ValueError(f"{where}: {rows} rows exceed one launch's grid")


def check_aligned(where: str, **tensors) -> None:
    """Every tensor's data starts on a 16-byte boundary (the kernel moves
    rows as uint4/int4)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must start on a 16-byte boundary")


def _banks(where: str, x, idx, idx_shape):
    """The gather of ``galois_banks`` / ``galois_banks_multi``: launcher
    ``where`` on x (k, B, n) with an idx of ``idx_shape(b, n)``."""
    if x.device.type == "cpu":
        return ref.galois_banks_ref(x, idx)
    lib = build.load("galois")
    if x.ndim != 3:
        raise ValueError(f"{where}: x must be (k, B, n), got {tuple(x.shape)}")
    k, b, n = x.shape
    _check_row(where, n, k * b)
    check_tensors(where, x.device, x=x, idx=idx)
    check_shape(where, "idx", idx, idx_shape(b, n))
    check_aligned(where, x=x, idx=idx)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = getattr(lib, where)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), k, b,
                             n, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def galois_banks(x, idx):
    """x: (k, B, n) int32; idx: (n,) int32 gather row shared by every
    (prime, batch) row.  out[p, b, j] = x[p, b, idx[j]]."""
    return _banks("galois_banks", x, idx, lambda b, n: (n,))


def galois_banks_multi(x, idx):
    """x: (k, B, n) int32; idx: (B, n) int32, row b applied to batch row b
    of every prime.  out[p, b, j] = x[p, b, idx[b, j]]."""
    return _banks("galois_banks_multi", x, idx, lambda b, n: (b, n))


def galois_digits(x, idx, *, shared: bool):
    """x: (d, k, B, n) int32 digit extensions, or (d, k, 1, n) with
    ``shared``; idx: (B, n) int32 rows shared by every digit and prime.
    out[d, p, b, j] = x[d, p, b, idx[b, j]], or x[d, p, 0, idx[b, j]]
    with ``shared`` (one digit stack fanned out to the B gather rows).
    Returns (d, k, B, n)."""
    if x.device.type == "cpu":
        return ref.galois_digits_banks_ref(x, idx)
    lib = build.load("galois")
    where = "galois_digits"
    if x.ndim != 4 or idx.ndim != 2:
        raise ValueError(f"{where}: x (d, k, B, n) and idx (B, n) expected, "
                         f"got {tuple(x.shape)}, {tuple(idx.shape)}")
    d, k, b, n = x.shape
    bi = idx.shape[0]
    _check_row(where, n, d * k * bi)
    check_tensors(where, x.device, x=x, idx=idx)
    check_shape(where, "x", x, (d, k, 1 if shared else bi, n))
    check_shape(where, "idx", idx, (bi, n))
    check_aligned(where, x=x, idx=idx)
    out = torch.empty((d, k, bi, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    rc = lib.galois_digits(x.data_ptr(), idx.data_ptr(), out.data_ptr(), d, k,
                           bi, n, int(shared), stream())
    raise_on(where, rc)
    COUNTS["galois_digits"].launches += 1
    return out
