"""Wrappers of the pointwise kernels: the key-switch digit MAC
(``csrc/dyadic_inner.cu``) and the incomplete ring's basecase product
(``csrc/dyadic_basemul.cu``).

``dyadic_inner_banks`` replaces the TPU kernel ``dyadic_inner_banks`` of
the reference's ``kernels/dyadic_kernel.py``:
out[p, b] = sum_d ext[d, p, b] * evk[d, p, (b)] mod q_p with 32-bit
Barrett products, for one key or both halves of a key switch's key in
one launch, with ext, the keys and the outputs read and written through
their strides.  ``dyadic_basemul_banks`` replaces the TPU kernel of
the same name: ML-KEM's degree-1 products mod (X^2 - γ_j) on the int16
lane; its launcher takes 2 pairs a thread in 32-bit words where n/2 is
even and every operand and gamma row is 4-byte aligned, and one pair a
thread otherwise (``csrc/dyadic_basemul.cu`` ``plan()``).
A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor passes the same checks and is
recorded as one launch (``ntt_kernel.meta_launch``).

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
                                            check_tensors, check_u32, meta_launch,
                                            raise_on, stream)
from repro_torch.runtime import op_cost
from repro_torch.runtime.roofline import BASEMUL_OPS

CUDA_ERROR_INVALID_VALUE = 1      # cudaErrorInvalidValue: a layout the launcher does not take


def _strided(where: str, device, **views) -> None:
    """int32 views on ``device`` whose ring axis (the last) is unit-stride;
    every other axis may have any stride."""
    for name, t in views.items():
        if t.device != device:
            raise KernelRefusal(f"{where}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise KernelRefusal(f"{where}: {name} must be torch.int32 (uint32 bit "
                                f"patterns), got {t.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise KernelRefusal(f"{where}: {name} must be unit-stride along n, got "
                                f"shape {tuple(t.shape)}, strides {t.stride()}")


def dyadic_inner_banks(ext, evk, qs, mus, *, lazy: bool, out=None, bits: int = 32):
    """ext: (d, k, B, n) int32, any strides but along n (the key switch's
    (digit, prime, B, n) transpose of the mod-up's stack, read in place);
    evk: one key, or a tuple of one or two keys, each (d, k, n) shared by
    the batch or (d, k, B, n) per batch row; qs/mus (k,).  Returns a
    (k, B, n) stack for one key, or a tuple of one a key: two keys are one
    launch, which reads ext once for both.  ``out``, in the same form, are
    (k, B, n) views unit-stride along n to write instead (the two halves
    of one stack, say).  ``bits`` is the moduli's Barrett trait: 32 (the
    RNS window) or 23 (``modmath.BARRETT23_WINDOW``, ML-DSA's q; on the
    card one key and 16-byte loads only, or ``KernelRefusal``)."""
    keys = evk if isinstance(evk, tuple) else (evk,)
    if bits not in (32, 23) or (bits == 23 and len(keys) != 1):
        raise KernelRefusal(f"dyadic_inner_banks: Barrett trait {bits} with {len(keys)} "
                            "keys; expected 32, or 23 with one key")
    if ext.device.type == "cpu":
        got = ref.dyadic_inner_banks_ref(ext, keys, qs, mus, lazy=lazy, bits=bits)
        if out is not None:
            got = tuple(o.copy_(g) for o, g in zip(out if isinstance(out, tuple)
                                                  else (out,), got))
        return got if isinstance(evk, tuple) else got[0]
    where = "dyadic_inner_banks"
    if ext.ndim != 4 or not 1 <= len(keys) <= 2 or any(e.ndim not in (3, 4) for e in keys):
        raise KernelRefusal(f"{where}: ext (d, k, B, n) and one or two evk (d, k, [B,] n) "
                            f"expected, got {tuple(ext.shape)}, "
                            f"{[tuple(e.shape) for e in keys]}")
    d, k, b, n = ext.shape
    if d == 0:
        raise KernelRefusal(f"{where}: no digits")
    check_tensors(where, ext.device, qs=qs, mus=mus)
    _strided(where, ext.device, ext=ext, **{f"evk{i}": e for i, e in enumerate(keys)})
    for i, e in enumerate(keys):
        check_shape(where, f"evk{i}", e, (d, k, b, n) if e.ndim == 4 else (d, k, n))
    check_shape(where, "qs", qs, (k,))
    check_shape(where, "mus", mus, (k,))
    if out is None:
        outs = tuple(ext.new_empty((k, b, n)) for _ in keys)
    else:
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) != len(keys):
            raise KernelRefusal(f"{where}: {len(outs)} outputs for {len(keys)} keys")
        _strided(where, ext.device, **{f"out{i}": o for i, o in enumerate(outs)})
        for i, o in enumerate(outs):
            check_shape(where, f"out{i}", o, (k, b, n))
    ret = outs if isinstance(evk, tuple) else outs[0]
    if ext.device.type == "meta":
        op_cost.record_kernel(where, [ext, *keys, qs, mus], list(outs))
        return ret
    lib = build.load("dyadic_inner")
    if ext.numel() == 0:
        return ret
    # (digit, prime, batch) strides in words, 0 along an axis of one (a
    # shared key has no batch axis), so any layout of it takes 16-byte loads
    words = lambda t: [s if m > 1 else 0 for m, s in zip(t.shape[:-1], t.stride()[:-1])]
    planes = [(e.data_ptr(), *words(e), *([] if e.ndim == 4 else [0])) for e in keys]
    planes += [(0, 0, 0, 0)] * (2 - len(keys))
    sinks = [(o.data_ptr(), *words(o)) for o in outs]
    sinks += [(0, 0, 0)] * (2 - len(outs))
    rc = lib.dyadic_inner_banks(ext.data_ptr(), *words(ext), *planes[0], *planes[1],
                                *sinks[0], *sinks[1], qs.data_ptr(), mus.data_ptr(),
                                d, k, b, n, int(lazy), bits, stream())
    if bits == 23 and rc == CUDA_ERROR_INVALID_VALUE:
        raise KernelRefusal(f"{where}: the 23-bit trait takes 16-byte aligned operands "
                            "with word strides a multiple of 4")
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return ret


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
    if a.device.type == "meta":
        return meta_launch(where, out, [a, b, qs, mus, gamma, gammap],
                           a.numel() // 2 * BASEMUL_OPS[lazy])
    lib = build.load("dyadic_basemul")
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
    check_tensors(where, a.device, a=a, b=b)
    out = torch.empty_like(a)
    if a.device.type == "meta":
        return meta_launch(where, out, [a, b])
    lib = build.load("dyadic")
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
    check_tensors(where, a.device, acc=acc, a=a, b=b)
    out = torch.empty_like(a)
    if a.device.type == "meta":
        return meta_launch(where, out, [acc, a, b])
    lib = build.load("dyadic")
    if out.numel() == 0:
        return out
    rc = lib.dyadic_mac(acc.data_ptr(), a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), q, mu, out.numel(), int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out
