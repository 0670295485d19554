"""Wrappers of the Galois gather kernels (``csrc/galois.cu``).

``galois_banks`` / ``galois_banks_multi`` / ``galois_digits`` replace the
TPU kernels ``galois_banks_pallas`` / ``galois_banks_multi_pallas`` /
``galois_digits_pallas`` of the reference's ``kernels/galois_kernel.py``:
the NTT-domain automorphism as a lane gather, with one shared index row,
one per batch element, or one per batch element applied to every digit
of a key-switch decomposition.  A CPU tensor goes to the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises.  Rows of
any length run: ``galois_banks`` splits every output row across blocks
that gather straight from device memory; the other two copy a source row
into a block's shared memory by bulk copies, whole up to ``MAX_ROW``
words and through a ring of pieces above.  Those bodies move rows as
16-byte vectors; a row length that is not a multiple of 4, or a tensor
that does not start on a 16-byte boundary (a view), takes the launcher's
one-word body instead, one output word a thread.  Indices follow the
reference's ``jnp.take`` on every device: one in [-n, 0) counts from the
end of the row (n + i), and any other outside [0, n) gives the all-ones
word (0xFFFFFFFF, -1 as an int32 bit pattern).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.ntt_kernel import (check_shape, check_tensors,
                                            raise_on, stream)

# the longest row that galois_banks_multi / galois_digits stage whole in
# one block's 227 KB of shared memory, less its 32 bytes of barriers
# (csrc/galois.cu kRowWords); a longer row passes through a ring of pieces
MAX_ROW = (232448 - 32) // 16 * 4


def _check_rows(where: str, rows: int) -> None:
    if rows >= 1 << 31:
        raise KernelRefusal(f"{where}: {rows} rows exceed one launch's grid")


def _banks(where: str, x, idx, idx_shape):
    """The gather of ``galois_banks`` / ``galois_banks_multi``: launcher
    ``where`` on x (k, B, n) with an idx of ``idx_shape(b, n)``."""
    if x.device.type == "cpu":
        return ref.galois_banks_ref(x, idx)
    lib = build.load("galois")
    if x.ndim != 3:
        raise KernelRefusal(f"{where}: x must be (k, B, n), got {tuple(x.shape)}")
    k, b, n = x.shape
    _check_rows(where, k * b)
    check_tensors(where, x.device, x=x, idx=idx)
    check_shape(where, "idx", idx, idx_shape(b, n))
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
    (prime, batch) row.  out[p, b, j] = x[p, b, idx[j]], idx[j] in
    [-n, n) (a negative index counts from the end), else all ones."""
    return _banks("galois_banks", x, idx, lambda b, n: (n,))


def galois_banks_multi(x, idx):
    """x: (k, B, n) int32; idx: (B, n) int32, row b applied to batch row b
    of every prime.  out[p, b, j] = x[p, b, idx[b, j]], with the index
    rule of ``galois_banks``."""
    return _banks("galois_banks_multi", x, idx, lambda b, n: (b, n))


def galois_digits(x, idx, *, shared: bool):
    """x: (d, k, B, n) int32 digit extensions, or (d, k, 1, n) with
    ``shared``; idx: (B, n) int32 rows shared by every digit and prime.
    out[d, p, b, j] = x[d, p, b, idx[b, j]], or x[d, p, 0, idx[b, j]]
    with ``shared`` (one digit stack fanned out to the B gather rows),
    with the index rule of ``galois_banks``.  Returns (d, k, B, n)."""
    if x.device.type == "cpu":
        return ref.galois_digits_banks_ref(x, idx)
    lib = build.load("galois")
    where = "galois_digits"
    if x.ndim != 4 or idx.ndim != 2:
        raise KernelRefusal(f"{where}: x (d, k, B, n) and idx (B, n) expected, "
                            f"got {tuple(x.shape)}, {tuple(idx.shape)}")
    d, k, b, n = x.shape
    bi = idx.shape[0]
    _check_rows(where, d * k * bi)
    check_tensors(where, x.device, x=x, idx=idx)
    check_shape(where, "x", x, (d, k, 1 if shared else bi, n))
    check_shape(where, "idx", idx, (bi, n))
    out = x.new_empty((d, k, bi, n))
    if out.numel() == 0:
        return out
    rc = lib.galois_digits(x.data_ptr(), idx.data_ptr(), out.data_ptr(), d, k,
                           bi, n, int(shared), stream())
    raise_on(where, rc)
    COUNTS["galois_digits"].launches += 1
    return out
