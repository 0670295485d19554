"""Wrappers of the Keccak kernels (``csrc/keccak.cu``): ML-KEM's hashes
(H, G, J), SampleNTT and PRF fused with CBD on the card.

They replace no TPU kernel: the reference hashes on the host with
``hashlib``.  ``keccak_hash`` is one sponge a row over a[r] || b[r] ||
extra at rate 72, 136 or 168 with the SHA3 or SHAKE domain byte;
``sample_ntt`` is FIPS 203 Alg. 7 over (rho (b, 32), i, j), its rejection
and its extra squeezes inside the kernel, stored in the port's CG order;
``prf_cbd`` is CBD_2(PRF_2(s, n0 + c)).  Byte rows are uint8 tensors of
any row stride (a column slice of a wider row is read where it is).

A CPU tensor goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises; a ``meta`` tensor passes the same checks
and is recorded as one launch with its permutations' integer
instructions (``ntt_kernel.meta_launch``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS, KernelRefusal, build, ref
from repro_torch.kernels.ntt_kernel import meta_launch, raise_on, stream
from repro_torch.pq import codec

RATES = (72, 136, 168)                 # SHA3-512; SHA3-256, SHAKE256; SHAKE128
SUFFIXES = (0x06, 0x1F)                # SHA3, SHAKE
# INT32 instructions of one Keccak-f[1600] at the floor: 24 rounds of 90
# operations on 64-bit lanes (theta 40, rho 24, chi 25, iota 1; a
# three-input logic function counted once), 2 instructions each
PERM_INT_OPS = 24 * 90 * 2
SAMPLE_BLOCKS = 3                      # SampleNTT's least squeezes a stream


def sponge_perms(length: int, rate: int, out_len: int) -> int:
    """Permutations of one sponge over ``length`` bytes squeezing
    ``out_len``: the absorbed blocks (padding adds at least one byte) and
    a further one for each squeezed block past the first."""
    return length // rate + 1 + (out_len - 1) // rate


def check_byte_rows(where: str, rows=None, **parts) -> int:
    """Every part a (rows, len) uint8 tensor on one device whose bytes in
    a row are adjacent; returns the row count."""
    device = None
    for name, t in parts.items():
        if t is None:
            continue
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise KernelRefusal(f"{where}: {name} must be (rows, bytes) uint8, got "
                                f"{t.dtype} {tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise KernelRefusal(f"{where}: {name}'s bytes must be adjacent in a row")
        if rows is None:
            rows = t.shape[0]
        if t.shape[0] != rows:
            raise KernelRefusal(f"{where}: {name} has {t.shape[0]} rows, expected {rows}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise KernelRefusal(f"{where}: {name} is on {t.device}, expected {device}")
    return rows


def _check_seed(where: str, name: str, t) -> int:
    rows = check_byte_rows(where, **{name: t})
    if t.shape[1] != 32:
        raise KernelRefusal(f"{where}: {name} rows of {t.shape[1]} bytes, expected 32")
    return rows


def check_cuda(where: str, t) -> None:
    if t.device.type != "cuda":
        raise KernelRefusal(f"{where}: CUDA tensors expected, got device {t.device}")


def keccak_hash(a, b=None, *, extra=None, rate: int, suffix: int, out_len: int):
    """a (rows, la), b (rows, lb) or None: uint8 rows; ``extra`` a byte
    or None.  Returns (rows, out_len) uint8: the sponge of ``rate``
    over a[r] || b[r] || extra with domain byte ``suffix``."""
    where = "keccak_hash"
    rows = check_byte_rows(where, a=a, b=b)
    if rate not in RATES or suffix not in SUFFIXES:
        raise KernelRefusal(f"{where}: rate {rate} and suffix {suffix:#x}: expected a "
                            f"rate of {RATES} and a suffix of {SUFFIXES}")
    if extra is not None and not 0 <= extra < 256:
        raise KernelRefusal(f"{where}: extra {extra} is not a byte")
    if out_len < 1:
        raise KernelRefusal(f"{where}: out_len {out_len}")
    if a.device.type == "cpu":
        return ref.keccak_hash_ref(a, b, extra, rate=rate, suffix=suffix, out_len=out_len)
    length = a.shape[1] + (0 if b is None else b.shape[1]) + (extra is not None)
    out = torch.empty((rows, out_len), dtype=torch.uint8, device=a.device)
    if a.device.type == "meta":
        return meta_launch(where, out, [t for t in (a, b) if t is not None],
                           rows * sponge_perms(length, rate, out_len) * PERM_INT_OPS)
    check_cuda(where, a)
    if rows == 0:
        return out
    lib = build.load("keccak")
    rc = lib.keccak_hash(a.data_ptr(), a.stride(0), a.shape[1],
                         0 if b is None else b.data_ptr(), 0 if b is None else b.stride(0),
                         0 if b is None else b.shape[1], -1 if extra is None else extra,
                         rate, suffix, out.data_ptr(), out_len, rows, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def sample_ntt(rho, *, transpose: bool):
    """rho (b, 32) uint8.  Returns (b, 3, 3, 256) int16: SampleNTT(rho ||
    j || i) in CG order at [r, i, j], or at [r, j, i] with ``transpose``
    (the matrix transposed, as encryption reads it)."""
    where = "keccak_sample_ntt"
    rows = _check_seed(where, "rho", rho)
    if rho.device.type == "cpu":
        return ref.sample_ntt_ref(rho, transpose)
    out = torch.empty((rows, 3, 3, codec.N), dtype=torch.int16, device=rho.device)
    if rho.device.type == "meta":
        return meta_launch(where, out, [rho], rows * 9 * SAMPLE_BLOCKS * PERM_INT_OPS)
    check_cuda(where, rho)
    if rows == 0:
        return out
    lib = build.load("keccak")
    rc = lib.keccak_sample_ntt(rho.data_ptr(), rho.stride(0), out.data_ptr(), rows,
                               int(transpose), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def prf_cbd(seed, *, n0: int, count: int):
    """seed (b, 32) uint8.  Returns (b, count, 256) int16 in [0, q):
    CBD_2(PRF_2(seed[r], n0 + c)) at [r, c]."""
    where = "keccak_prf_cbd"
    rows = _check_seed(where, "seed", seed)
    if count < 1 or not 0 <= n0 or n0 + count > 256:
        raise KernelRefusal(f"{where}: nonces {n0} .. {n0 + count - 1} are not bytes")
    if seed.device.type == "cpu":
        return ref.prf_cbd_ref(seed, n0, count)
    out = torch.empty((rows, count, codec.N), dtype=torch.int16, device=seed.device)
    if seed.device.type == "meta":
        return meta_launch(where, out, [seed], rows * count * PERM_INT_OPS)
    check_cuda(where, seed)
    if rows == 0:
        return out
    lib = build.load("keccak")
    rc = lib.keccak_prf_cbd(seed.data_ptr(), seed.stride(0), n0, count, out.data_ptr(),
                            rows, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out
