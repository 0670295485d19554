"""Wrappers of ML-KEM's codec kernels (``csrc/mlkem_codec.cu``): the key's
ByteDecode12 with FIPS 203 §7.2's check, and the end of encryption
(the error terms and the message added, Compress and ByteEncode into the
ciphertext, K taken from G, rows whose key failed zeroed).

They replace no TPU kernel: the reference encodes and decodes on the
host in numpy.  A CPU tensor goes to the plain version in ``kernels.ref``
(``pq.codec``'s tensor ops); a CUDA tensor launches the kernel or
raises; a ``meta`` tensor passes the same checks and is recorded as one
launch (``ntt_kernel.meta_launch``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.keccak_kernel import check_byte_rows, check_cuda
from repro_torch.kernels.ntt_kernel import check_shape, meta_launch, raise_on, stream

N, K = 256, 3
KEY_T_BYTES = 384 * K          # the encoded t̂ (or ŝ) a key row starts with
CT_BYTES = 32 * (10 * K + 4)


def _rows16(where: str, name: str, t: torch.Tensor, shape: tuple) -> None:
    check_shape(where, name, t, shape)
    if t.dtype != torch.int16 or not t.is_contiguous():
        raise KernelRefusal(f"{where}: {name} must be contiguous int16")


def decode_check(ek):
    """ek (b, >= 1152) uint8 rows.  Returns (t_hat (b, 3, 256) int16 in CG
    order, mod q; ok (b,) bool: no 12-bit field of the row at q or above)."""
    where = "mlkem_decode_check"
    rows = check_byte_rows(where, ek=ek)
    if ek.shape[1] < KEY_T_BYTES:
        raise KernelRefusal(f"{where}: rows of {ek.shape[1]} bytes, fewer than "
                            f"{KEY_T_BYTES}")
    if ek.device.type == "cpu":
        return ref.mlkem_decode_check_ref(ek)
    t_hat = torch.empty((rows, K, N), dtype=torch.int16, device=ek.device)
    ok = torch.empty((rows,), dtype=torch.uint8, device=ek.device)
    if ek.device.type == "meta":
        return meta_launch(where, t_hat, [ek[:, :KEY_T_BYTES]]), ok.bool()
    check_cuda(where, ek)
    if rows == 0:
        return t_hat, ok.bool()
    lib = build.load("mlkem_codec")
    rc = lib.mlkem_decode_check(ek.data_ptr(), ek.stride(0), t_hat.data_ptr(),
                                ok.data_ptr(), rows, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return t_hat, ok.view(torch.bool)


def encaps_tail(u, v, e, m, kr=None, ok=None):
    """u (b, 3, 256), v (b, 256) int16 in [0, q); e (b, 4, 256) int16 (e1,
    e2); m (b, 32) uint8; kr (b, >= 32) uint8 or None; ok (b,) bool or
    None.  Returns (K (b, 32) uint8 or None, ct (b, 1088) uint8), rows
    whose ok is False zeroed."""
    where = "mlkem_encaps_tail"
    rows = check_byte_rows(where, m=m, kr=kr)
    _rows16(where, "u", u, (rows, K, N))
    _rows16(where, "v", v, (rows, N))
    _rows16(where, "e", e, (rows, K + 1, N))
    if m.shape[1] != 32 or (kr is not None and kr.shape[1] < 32):
        raise KernelRefusal(f"{where}: m rows of 32 bytes and kr rows of 32 or more "
                            f"expected, got {tuple(m.shape)}, "
                            f"{None if kr is None else tuple(kr.shape)}")
    if ok is not None:
        check_shape(where, "ok", ok, (rows,))
        if ok.dtype != torch.bool or not ok.is_contiguous():
            raise KernelRefusal(f"{where}: ok must be a contiguous bool row")
    if u.device.type == "cpu":
        return ref.mlkem_encaps_tail_ref(u, v, e, m, kr, ok)
    ct = torch.empty((rows, CT_BYTES), dtype=torch.uint8, device=u.device)
    key = None if kr is None else torch.empty((rows, 32), dtype=torch.uint8,
                                              device=u.device)
    if u.device.type == "meta":
        return key, meta_launch(where, ct, [u, v, e, m])
    check_cuda(where, u)
    if rows == 0:
        return key, ct
    lib = build.load("mlkem_codec")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = lib.mlkem_encaps_tail(u.data_ptr(), v.data_ptr(), e.data_ptr(), m.data_ptr(),
                               m.stride(0), ptr(kr), 0 if kr is None else kr.stride(0),
                               ptr(ok), ptr(key), ct.data_ptr(), rows, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return key, ct
