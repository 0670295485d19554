"""Wrappers of ML-DSA's codec kernels (``csrc/mldsa_codec.cu``): the
signing loop's w1Encode(HighBits(w)), its bounds and hint count (the
accept verdict of each slot), and sigEncode of the accepted slots into
the output ring.

They replace no TPU kernel: the reference signs on the host.  A CPU
tensor goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises; a ``meta`` tensor passes the same checks
and is recorded as one launch (``ntt_kernel.meta_launch``).

Layouts (every tensor contiguous, int32 residues mod q = 8380417): y
(S, l, 256) as ExpandMask gives it; w (k, S, 256) and cs (l + 2k, S,
256), the rows cs1, cs2 and ct0, as the digit MAC and the inverse NTT
give them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.keccak_kernel import check_byte_rows, check_cuda
from repro_torch.kernels.ntt_kernel import meta_launch, raise_on, stream
from repro_torch.pq import codec

N, K, L = codec.N, codec.DSA_K, codec.DSA_L
W1_BYTES = 32 * K * codec.DSA_W1_BITS          # 768


def _stack(where: str, name: str, t, shape: tuple, dtype=torch.int32) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise KernelRefusal(f"{where}: {name} must be a contiguous {shape} {dtype}, got "
                            f"{t.dtype} {tuple(t.shape)}{'' if t.is_contiguous() else ' strided'}")


def _same_device(where: str, *ts) -> None:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise KernelRefusal(f"{where}: operands on {sorted(map(str, devices))}")


def _launch(where: str, *args) -> None:
    rc = getattr(build.load("mldsa_codec"), where)(*args, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1


def _ring_stacks(where: str, y, w, cs) -> int:
    rows = y.shape[0] if y.ndim == 3 else -1
    _stack(where, "y", y, (rows, L, N))
    _stack(where, "w", w, (K, rows, N))
    _stack(where, "cs", cs, (L + 2 * K, rows, N))
    return rows


def w1_encode(w):
    """w (k, S, 256) int32 residues.  Returns (S, 768) uint8:
    w1Encode(HighBits(w)) of each slot."""
    where = "mldsa_w1_encode"
    rows = w.shape[1] if w.ndim == 3 else -1
    _stack(where, "w", w, (K, rows, N))
    if w.device.type == "cpu":
        return ref.w1_encode_ref(w)
    out = torch.empty((rows, W1_BYTES), dtype=torch.uint8, device=w.device)
    if w.device.type == "meta":
        return meta_launch(where, out, [w])
    check_cuda(where, w)
    if rows:
        _launch(where, w.data_ptr(), out.data_ptr(), rows)
    return out


def sign_check(y, w, cs, active):
    """y, w, cs as in the module docstring; active (S,) bool.  Returns (S,)
    bool: the slot is active and its iteration meets every bound of
    Sign_internal (||z||, ||r0||, ||ct0|| and the hint count)."""
    where = "mldsa_check"
    rows = _ring_stacks(where, y, w, cs)
    _stack(where, "active", active, (rows,), torch.bool)
    _same_device(where, y, w, cs, active)
    if y.device.type == "cpu":
        return ref.sign_check_ref(y, w, cs, active)
    ok = torch.empty((rows,), dtype=torch.bool, device=y.device)
    if y.device.type == "meta":
        return meta_launch(where, ok, [y, w, cs])
    check_cuda(where, y)
    if rows:
        _launch(where, y.data_ptr(), w.data_ptr(), cs.data_ptr(), active.data_ptr(),
                ok.data_ptr(), rows)
    return ok


def sign_emit(ct, y, w, cs, dest, ids, kappa, ring, ring_ids, ring_iters):
    """In place: sigEncode(c-tilde, z, h) of each slot s whose dest[s] is
    below R into ring[dest[s]], with ids[s] and kappa[s] / l + 1 into
    ring_ids and ring_iters.  ct (S, 48) uint8 rows; y, w, cs as in the
    module docstring; dest and ids (S,) int64, kappa (S,) int32; ring
    (R + 1, 3309) uint8, ring_ids (R + 1,) int64, ring_iters (R + 1,)
    int32, their last row holding no entry."""
    where = "mldsa_emit"
    rows = _ring_stacks(where, y, w, cs)
    check_byte_rows(where, rows, ct=ct)
    if ct.shape[1] != codec.DSA_CT_BYTES:
        raise KernelRefusal(f"{where}: ct rows of {ct.shape[1]} bytes, expected 48")
    _stack(where, "dest", dest, (rows,), torch.int64)
    _stack(where, "ids", ids, (rows,), torch.int64)
    _stack(where, "kappa", kappa, (rows,), torch.int32)
    ring_rows = ring.shape[0] - 1
    _stack(where, "ring", ring, (ring_rows + 1, codec.DSA_SIG_BYTES), torch.uint8)
    _stack(where, "ring_ids", ring_ids, (ring_rows + 1,), torch.int64)
    _stack(where, "ring_iters", ring_iters, (ring_rows + 1,), torch.int32)
    _same_device(where, ct, y, w, cs, dest, ids, kappa, ring, ring_ids, ring_iters)
    if y.device.type == "cpu":
        return ref.sign_emit_ref(ct, y, w, cs, dest, ids, kappa, ring, ring_ids, ring_iters)
    if y.device.type == "meta":
        meta_launch(where, ring, [ct, y, w, cs])
        return None
    check_cuda(where, y)
    if rows:
        _launch(where, ct.data_ptr(), ct.stride(0), y.data_ptr(), w.data_ptr(), cs.data_ptr(),
                dest.data_ptr(), ids.data_ptr(), kappa.data_ptr(), ring.data_ptr(),
                ring_ids.data_ptr(), ring_iters.data_ptr(), rows, ring_rows)
    return None
