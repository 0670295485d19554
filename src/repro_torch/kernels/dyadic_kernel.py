"""Wrappers of the pointwise kernels: the key-switch digit MAC
(``csrc/dyadic_inner.cu``) and the incomplete ring's basecase product
(``csrc/dyadic_basemul.cu``).

``dyadic_inner_banks`` replaces the TPU kernel ``dyadic_inner_banks`` of
the reference's ``kernels/dyadic_kernel.py``:
out[p, b] = sum_d ext[d, p, b] * evk[d, p, (b)] mod q_p with 32-bit
Barrett products.  ``dyadic_basemul_banks`` replaces the TPU kernel of
the same name: ML-KEM's degree-1 products mod (X^2 - γ_j) on the int16
lane; its launcher takes 2 pairs a thread in 32-bit words where n/2 is
even and every operand and gamma row is 4-byte aligned, and one pair a
thread otherwise (``csrc/dyadic_basemul.cu`` ``plan()``).
A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.

``dyadic_mul`` / ``dyadic_mac`` (``csrc/dyadic.cu``) replace the
single-prime TPU kernels of the same names: a * b mod q and
acc + a * b mod q with the u32 Barrett product, elementwise over
operands of one shape.  They refuse, on every device, an int16 tensor
(the single-prime lane is uint32 only), operands of different shapes,
and mu = 0, which ``make_ntt_params`` leaves for a modulus outside the
Barrett window (2^28, 2^30), where the product would be wrong.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.ntt_kernel import (check_lane, check_shape,
                                            check_tensors, check_u32, raise_on,
                                            stream)


def dyadic_inner_banks(ext, evk, qs, mus, *, lazy: bool):
    """ext: (d, k, B, n) int32; evk: (d, k, n) shared by the batch or
    (d, k, B, n) per batch row; qs/mus (k,).  Returns (k, B, n)."""
    if ext.device.type == "cpu":
        return ref.dyadic_inner_banks_ref(ext, evk, qs, mus, lazy=lazy)
    lib = build.load("dyadic_inner")
    where = "dyadic_inner_banks"
    if ext.ndim != 4 or evk.ndim not in (3, 4):
        raise KernelRefusal(f"{where}: ext (d, k, B, n) and evk (d, k, [B,] n) "
                            f"expected, got {tuple(ext.shape)}, {tuple(evk.shape)}")
    d, k, b, n = ext.shape
    if d == 0:
        raise KernelRefusal(f"{where}: no digits")
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


def dyadic_basemul_banks(a, b, qs, mus, gamma, gammap, *, lazy: bool):
    """a, b: (k, B, n) int16 canonical NTT-domain operands of an
    incomplete ring, pair j = (x[j], x[j + n/2]); qs/mus (k,);
    gamma/gammap (k, n/2) per-pair ζ factors and Shoup companions, all
    int16 (uint16 bit patterns).  Returns (k, B, n) int16 in [0, q)."""
    where = "dyadic_basemul_banks"
    lane = check_lane(where, a=a, b=b, qs=qs, mus=mus, gamma=gamma, gammap=gammap)
    if lane != torch.int16:
        raise KernelRefusal(f"{where}: the basecase product runs on the int16 "
                            f"(uint16) lane only, got {lane}")
    if a.device.type == "cpu":
        return ref.dyadic_basemul_banks_ref(a, b, qs, mus, gamma, gammap, lazy=lazy)
    lib = build.load("dyadic_basemul")
    if a.ndim != 3:
        raise KernelRefusal(f"{where}: a must be (k, B, n), got {tuple(a.shape)}")
    k, bb, n = a.shape
    if n < 2 or n & (n - 1):
        raise KernelRefusal(f"{where}: n={n} must be a power of two >= 2")
    check_tensors(where, a.device, dtype=lane, a=a, b=b, qs=qs, mus=mus,
                  gamma=gamma, gammap=gammap)
    check_shape(where, "b", b, (k, bb, n))
    check_shape(where, "qs", qs, (k,))
    check_shape(where, "mus", mus, (k,))
    check_shape(where, "gamma", gamma, (k, n // 2))
    check_shape(where, "gammap", gammap, (k, n // 2))
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    rc = lib.dyadic_basemul_banks(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  qs.data_ptr(), mus.data_ptr(), gamma.data_ptr(),
                                  gammap.data_ptr(), k, bb, n, int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def _check_pointwise(where: str, mu: int, **tensors) -> None:
    check_u32(where, **tensors)
    shapes = {name: tuple(t.shape) for name, t in tensors.items()}
    if len(set(shapes.values())) != 1:
        raise KernelRefusal(f"{where}: operand shapes differ: {shapes}")
    if mu == 0:
        raise KernelRefusal(f"{where}: Barrett mu is 0: the modulus lies outside "
                            "the u32 Barrett window (2^28, 2^30)")


def dyadic_mul(a, b, *, q: int, mu: int, lazy: bool):
    """a, b: int32 residues in [0, q) of one shape; mu = floor(2^60 / q).
    Returns a * b mod q in [0, q).  The lazy and eager products are one
    op sequence (the [0, 2q) Barrett band, then a subtract of q), so the
    kernel takes no flag; ``lazy`` reaches the plain version only."""
    where = "dyadic_mul"
    _check_pointwise(where, mu, a=a, b=b)
    if a.device.type == "cpu":
        return ref.dyadic_mul_ref(a, b, q, mu, lazy=lazy)
    lib = build.load("dyadic")
    check_tensors(where, a.device, a=a, b=b)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    rc = lib.dyadic_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), q, mu,
                        out.numel(), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def dyadic_mac(acc, a, b, *, q: int, mu: int, lazy: bool):
    """acc, a, b: int32 residues in [0, q) of one shape.  Returns
    acc + a * b mod q in [0, q)."""
    where = "dyadic_mac"
    _check_pointwise(where, mu, acc=acc, a=a, b=b)
    if a.device.type == "cpu":
        return ref.dyadic_mac_ref(acc, a, b, q, mu, lazy=lazy)
    lib = build.load("dyadic")
    check_tensors(where, a.device, acc=acc, a=a, b=b)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    rc = lib.dyadic_mac(acc.data_ptr(), a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), q, mu, out.numel(), int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out
