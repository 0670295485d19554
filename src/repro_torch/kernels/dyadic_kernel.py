"""Wrapper of the key-switch digit MAC kernel (``csrc/dyadic_inner.cu``).

``dyadic_inner_banks`` replaces the TPU kernel ``dyadic_inner_banks`` of
the reference's ``kernels/dyadic_kernel.py``:
out[p, b] = sum_d ext[d, p, b] * evk[d, p, (b)] mod q_p with 32-bit
Barrett products.  A CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, build, ref
from repro_torch.kernels.ntt_kernel import (check_shape, check_tensors,
                                            raise_on, stream)


def dyadic_inner_banks(ext, evk, qs, mus, *, lazy: bool):
    """ext: (d, k, B, n) int32; evk: (d, k, n) shared by the batch or
    (d, k, B, n) per batch row; qs/mus (k,).  Returns (k, B, n)."""
    if ext.device.type == "cpu":
        return ref.dyadic_inner_banks_ref(ext, evk, qs, mus, lazy=lazy)
    lib = build.load("dyadic_inner")
    where = "dyadic_inner_banks"
    if ext.ndim != 4 or evk.ndim not in (3, 4):
        raise ValueError(f"{where}: ext (d, k, B, n) and evk (d, k, [B,] n) "
                         f"expected, got {tuple(ext.shape)}, {tuple(evk.shape)}")
    d, k, b, n = ext.shape
    if d == 0:
        raise ValueError(f"{where}: no digits")
    check_tensors(where, ext.device, ext=ext, evk=evk, qs=qs, mus=mus)
    per_batch = evk.ndim == 4
    check_shape(where, "evk", evk, (d, k, b, n) if per_batch else (d, k, n))
    check_shape(where, "qs", qs, (k,))
    check_shape(where, "mus", mus, (k,))
    out = torch.empty((k, b, n), dtype=torch.int32, device=ext.device)
    if out.numel() == 0:
        return out
    rc = lib.dyadic_inner_banks(ext.data_ptr(), evk.data_ptr(), out.data_ptr(),
                                qs.data_ptr(), mus.data_ptr(), d, k, b, n,
                                int(per_batch), int(lazy), stream())
    raise_on(where, rc)
    COUNTS["dyadic_inner_banks"].launches += 1
    return out
