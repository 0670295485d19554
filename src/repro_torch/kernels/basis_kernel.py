"""Wrappers of the key switch's RNS base conversions (``csrc/basis.cu``).

``extend_centered`` is the mod-up of one prime per digit: each
coefficient digit, centred about its own prime, reduced onto each of kt
primes, written as the (kt, d, B, n) stack the forward banks transform.
``base_conv`` is hybrid key switching's fast base conversion, from
groups of primes (the digits, or the special primes of a mod-down) onto
kt primes, into the same layout; its plain version computes the
formula's exact residues.  ``mod_down_tail`` is the end of
the mod-down: (acc - extn) * P^-1 mod q_j, with an optional addend (the
ciphertext half a key switch's output is added to) folded in, read and
written through (prime, batch) strides.  None has a TPU kernel: the
reference runs the first and the last as XLA elementwise ops, and has no
hybrid key switching.  The plain versions of those two in ``kernels.ref``
are the port's former int64 PyTorch chains, and each kernel copies their
op sequence.

A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor passes the same checks and is
recorded as one launch (``ntt_kernel.meta_launch``).  The moduli must
lie below 2^31 (every RNS prime is below 2^30): the launcher cannot read
their values without a sync, so that is the caller's to keep.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.ntt_kernel import (check_shape, check_tensors, meta_launch,
                                            raise_on, stream)


def extend_centered(ci, src_qs, dst_qs):
    """ci: (d, B, n) int32 digits, digit i mod src_qs[i]; src_qs (d,),
    dst_qs (kt,).  Returns (kt, d, B, n) int32."""
    if ci.device.type == "cpu":
        return ref.extend_centered_ref(ci, src_qs, dst_qs)
    where = "extend_centered"
    if ci.ndim != 3 or dst_qs.ndim != 1:
        raise KernelRefusal(f"{where}: ci (d, B, n) and dst_qs (kt,) expected, got "
                            f"{tuple(ci.shape)}, {tuple(dst_qs.shape)}")
    d, b, n = ci.shape
    check_tensors(where, ci.device, ci=ci, src_qs=src_qs, dst_qs=dst_qs)
    check_shape(where, "src_qs", src_qs, (d,))
    out = ci.new_empty((dst_qs.shape[0], d, b, n))
    if ci.device.type == "meta":
        return meta_launch(where, out, [ci, src_qs, dst_qs])
    lib = build.load("basis")
    if out.numel() == 0:
        return out
    rc = lib.extend_centered(ci.data_ptr(), out.data_ptr(), src_qs.data_ptr(),
                             dst_qs.data_ptr(), d, dst_qs.shape[0], b * n, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


CONV_KEYS = ("src", "sq", "w", "wp", "cnt", "mat", "copy", "dst")
SLOTS = (4, 8, 16)      # the conversion tables' stride a group: the kernel's instantiations
MAX_TARGETS = 512       # kMaxTargets


def base_conv(x, conv: dict):
    """x: (R, B, n) int32 residue rows; conv: a conversion table
    (``fhe.batched.conv_table``) of ``groups`` groups onto kt targets,
    whose source rows lie below R.  Returns (kt, groups, B, n) int32."""
    src, sq, w, wp, cnt, mat, copy, dst = (conv[k] for k in CONV_KEYS)
    if x.device.type == "cpu":
        return ref.base_conv_ref(x, src, sq, w, wp, cnt, mat, copy, dst)
    where = "base_conv"
    if x.ndim != 3 or src.ndim != 2 or dst.ndim != 1:
        raise KernelRefusal(f"{where}: x (R, B, n), src (groups, slots) and dst (kt,) "
                            f"expected, got {tuple(x.shape)}, {tuple(src.shape)}, "
                            f"{tuple(dst.shape)}")
    _, b, n = x.shape
    groups, slots = src.shape
    kt = dst.shape[0]
    check_tensors(where, x.device, x=x, src=src, sq=sq, w=w, wp=wp, cnt=cnt, mat=mat,
                  copy=copy, dst=dst)
    for name, t in (("sq", sq), ("w", w), ("wp", wp)):
        check_shape(where, name, t, (groups, slots))
    check_shape(where, "cnt", cnt, (groups,))
    check_shape(where, "mat", mat, (groups, kt, slots))
    check_shape(where, "copy", copy, (groups, kt))
    if slots not in SLOTS or kt > MAX_TARGETS:
        raise KernelRefusal(f"{where}: tables of {slots} slots a group onto {kt} targets; "
                            f"the kernel takes {SLOTS} slots and up to {MAX_TARGETS} targets")
    out = x.new_empty((kt, groups, b, n))
    if x.device.type == "meta":
        return meta_launch(where, out, [x, src, sq, w, wp, cnt, mat, copy, dst])
    lib = build.load("basis")
    if out.numel() == 0:
        return out
    rc = lib.base_conv(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in
                                                       (src, sq, w, wp, cnt, mat, copy, dst)),
                       groups, slots, kt, b * n, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def _check_rows(where: str, device, **views) -> None:
    """int32 (k, B, n) views on ``device`` whose words run contiguous
    along n; the prime and batch axes may have any strides."""
    for name, t in views.items():
        if t.device != device:
            raise KernelRefusal(f"{where}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise KernelRefusal(f"{where}: {name} must be torch.int32 (uint32 bit "
                                f"patterns), got {t.dtype}")
        if t.ndim != 3 or (t.stride(2) != 1 and t.shape[2] > 1):
            raise KernelRefusal(f"{where}: {name} must be a (k, B, n) view with unit "
                                f"stride along n, got shape {tuple(t.shape)}, "
                                f"strides {t.stride()}")


def mod_down_tail(acc, extn, qs, pinv, pinv_p, addend=None, *, batch_leading: bool):
    """acc, extn: (k, B, n) int32 residues in [0, q_j) (acc any strides on
    its first two axes); qs, pinv, pinv_p (k,).  Returns (k, B, n), or
    (B, k, n) with ``batch_leading``; ``addend``, in the output's layout
    with Ba <= B batch columns, is added mod q_j to the first Ba."""
    if acc.device.type == "cpu":
        return ref.mod_down_tail_ref(acc, extn, qs, pinv, pinv_p, addend,
                                     batch_leading=batch_leading)
    where = "mod_down_tail"
    if acc.ndim != 3:
        raise KernelRefusal(f"{where}: acc must be (k, B, n), got {tuple(acc.shape)}")
    k, b, n = acc.shape
    device = acc.device
    check_tensors(where, device, qs=qs, pinv=pinv, pinv_p=pinv_p)
    views = {"acc": acc, "extn": extn}
    if addend is not None:
        views["addend"] = addend
    _check_rows(where, device, **views)
    check_shape(where, "extn", extn, (k, b, n))
    for name, t in (("qs", qs), ("pinv", pinv), ("pinv_p", pinv_p)):
        check_shape(where, name, t, (k,))
    out = acc.new_empty((b, k, n) if batch_leading else (k, b, n))
    # (prime, batch) strides of each operand, in words
    strides = lambda t: (t.stride(1), t.stride(0)) if batch_leading else t.stride()[:2]
    badd = 0
    if addend is not None:
        badd = addend.shape[0 if batch_leading else 1]
        full = (badd, k, n) if batch_leading else (k, badd, n)
        if badd > b or tuple(addend.shape) != full:
            raise KernelRefusal(f"{where}: addend {tuple(addend.shape)} for an output "
                                f"of {tuple(out.shape)}")
    if device.type == "meta":
        reads = [acc, extn, qs, pinv, pinv_p] + ([addend] if addend is not None else [])
        return meta_launch(where, out, reads)
    lib = build.load("basis")
    if out.numel() == 0:
        return out
    add_ptr, add_sj, add_sb = ((addend.data_ptr(), *strides(addend)) if addend is not None
                               else (0, 0, 0))
    rc = lib.mod_down_tail(acc.data_ptr(), *acc.stride()[:2],
                           extn.data_ptr(), *extn.stride()[:2],
                           add_ptr, add_sj, add_sb, badd,
                           out.data_ptr(), *strides(out),
                           qs.data_ptr(), pinv.data_ptr(), pinv_p.data_ptr(),
                           k, b, n, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out
