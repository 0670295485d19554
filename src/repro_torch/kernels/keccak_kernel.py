"""Wrappers of the Keccak kernels (``csrc/keccak.cu``): ML-KEM's hashes
(H, G, J), SampleNTT and PRF fused with CBD on the card; ML-DSA's
ExpandMask, SampleInBall, ExpandA, ExpandS and the signing stream's
refill hashes (mu and rho'').

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


# ------------------------------------------------------------ ML-DSA
# FIPS 204's samplers and the signing stream's refill hashes.  The
# outputs are int32 residues mod q = 8380417 (the u32 lane), in FIPS
# 204's NTT order where they are NTT-domain (it is the port's).

DSA_K, DSA_L = codec.DSA_K, codec.DSA_L
MASK_PERMS = 5                         # an ExpandMask stream: 640 bytes at rate 136
REJ_NTT_BLOCKS = 5                     # RejNTTPoly's least squeezes (768 bytes at 168)
REJ_BOUNDED_BLOCKS = 2                 # RejBoundedPoly's least (256 half-bytes at 136)


def _int_rows(where: str, name: str, t, rows: int, dtype) -> None:
    if t.dtype != dtype or t.shape != (rows,) or not t.is_contiguous():
        raise KernelRefusal(f"{where}: {name} must be a contiguous ({rows},) {dtype}, got "
                            f"{t.dtype} {tuple(t.shape)}")


def _launch(where: str, fn: str, *args) -> None:
    rc = getattr(build.load("keccak"), fn)(*args, stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1


def expand_mask(rho, kappa):
    """rho (S, 64) uint8, kappa (S,) int32.  Returns (S, 5, 256) int32:
    ExpandMask(rho[s], kappa[s]) mod q, its 5 SHAKE256 streams fused with
    their 20-bit BitUnpack."""
    where = "keccak_expand_mask"
    rows = check_byte_rows(where, rho=rho)
    if rho.shape[1] != 64:
        raise KernelRefusal(f"{where}: rho rows of {rho.shape[1]} bytes, expected 64")
    _int_rows(where, "kappa", kappa, rows, torch.int32)
    if kappa.device != rho.device:
        raise KernelRefusal(f"{where}: kappa is on {kappa.device}, expected {rho.device}")
    if rho.device.type == "cpu":
        return ref.expand_mask_ref(rho, kappa)
    out = torch.empty((rows, DSA_L, codec.N), dtype=torch.int32, device=rho.device)
    if rho.device.type == "meta":
        return meta_launch(where, out, [rho, kappa], rows * DSA_L * MASK_PERMS * PERM_INT_OPS)
    check_cuda(where, rho)
    if rows:
        _launch(where, where, rho.data_ptr(), rho.stride(0), kappa.data_ptr(), out.data_ptr(),
                rows)
    return out


def sample_in_ball(ct):
    """ct (S, 48) uint8.  Returns (S, 256) int32: SampleInBall(ct[s]), its
    tau = 49 coefficients +-1 as 1 and q - 1."""
    where = "keccak_sample_in_ball"
    rows = check_byte_rows(where, ct=ct)
    if ct.shape[1] != codec.DSA_CT_BYTES:
        raise KernelRefusal(f"{where}: rows of {ct.shape[1]} bytes, expected "
                            f"{codec.DSA_CT_BYTES}")
    if ct.device.type == "cpu":
        return ref.sample_in_ball_ref(ct)
    out = torch.empty((rows, codec.N), dtype=torch.int32, device=ct.device)
    if ct.device.type == "meta":
        return meta_launch(where, out, [ct], rows * PERM_INT_OPS)
    check_cuda(where, ct)
    if rows:
        _launch(where, where, ct.data_ptr(), ct.stride(0), out.data_ptr(), rows)
    return out


def rej_ntt_poly(rho):
    """rho (b, 32) uint8.  Returns (b, 6, 5, 256) int32: ExpandA(rho),
    Â[r, s] = RejNTTPoly(rho || s || r)."""
    where = "keccak_rej_ntt_poly"
    rows = _check_seed(where, "rho", rho)
    if rho.device.type == "cpu":
        return ref.rej_ntt_poly_ref(rho)
    out = torch.empty((rows, DSA_K, DSA_L, codec.N), dtype=torch.int32, device=rho.device)
    if rho.device.type == "meta":
        return meta_launch(where, out, [rho],
                           rows * DSA_K * DSA_L * REJ_NTT_BLOCKS * PERM_INT_OPS)
    check_cuda(where, rho)
    if rows:
        _launch(where, where, rho.data_ptr(), rho.stride(0), out.data_ptr(), rows)
    return out


def rej_bounded(rho, *, n0: int, count: int):
    """rho (b, 64) uint8.  Returns (b, count, 256) int32 residues:
    RejBoundedPoly(rho[r] || n0 + c) at eta = 4 (ExpandS's s1 at n0 = 0
    and s2 at n0 = l)."""
    where = "keccak_rej_bounded"
    rows = check_byte_rows(where, rho=rho)
    if rho.shape[1] != 64:
        raise KernelRefusal(f"{where}: rho rows of {rho.shape[1]} bytes, expected 64")
    if count < 1 or n0 < 0 or n0 + count > 1 << 16:
        raise KernelRefusal(f"{where}: nonces {n0} .. {n0 + count - 1} are not 16-bit")
    if rho.device.type == "cpu":
        return ref.rej_bounded_ref(rho, n0, count)
    out = torch.empty((rows, count, codec.N), dtype=torch.int32, device=rho.device)
    if rho.device.type == "meta":
        return meta_launch(where, out, [rho],
                           rows * count * REJ_BOUNDED_BLOCKS * PERM_INT_OPS)
    check_cuda(where, rho)
    if rows:
        _launch(where, where, rho.data_ptr(), rho.stride(0), n0, count, out.data_ptr(), rows)
    return out


def mu_rho(tr, key, msg, rnd, slots, reqs, count, mu_out, rho_out):
    """The signing stream's refill hashes, in place: for the first
    ``count`` (a (1,) int64 tensor on the device) entries i of slots and
    reqs ((S,) int64), mu = SHAKE256(tr || msg[reqs[i]], 64) and rho'' =
    SHAKE256(key || rnd[reqs[i]] || mu, 64) into rows slots[i] of mu_out
    and rho_out ((S + 1, 64) uint8).  tr (64,), key (32,), msg (P, m) and
    rnd (P, 32) uint8.  Entries past ``count`` do no work on the card (the
    plain version hashes them into the last row, which takes no slot)."""
    where = "keccak_mu_rho"
    rows = slots.shape[0] if slots.ndim == 1 else -1
    _int_rows(where, "slots", slots, rows, torch.int64)
    _int_rows(where, "reqs", reqs, rows, torch.int64)
    _int_rows(where, "count", count, 1, torch.int64)
    check_byte_rows(where, msg=msg, rnd=rnd)
    check_byte_rows(where, tr=tr[None], key=key[None])
    check_byte_rows(where, mu_out=mu_out, rho_out=rho_out)
    if (tr.numel(), key.numel(), rnd.shape[1]) != (64, 32, 32) or \
            mu_out.shape != (rows + 1, 64) or rho_out.shape != (rows + 1, 64) or \
            not (mu_out.is_contiguous() and rho_out.is_contiguous()):
        raise KernelRefusal(f"{where}: tr (64,), key (32,), rnd (P, 32) and contiguous "
                            f"({rows + 1}, 64) outputs expected")
    devices = {t.device for t in (tr, key, msg, rnd, slots, reqs, count, mu_out)}
    if len(devices) != 1:
        raise KernelRefusal(f"{where}: operands on {sorted(map(str, devices))}")
    if slots.device.type == "cpu":
        return ref.mu_rho_ref(tr, key, msg, rnd, slots, reqs, count, mu_out, rho_out)
    if slots.device.type == "meta":
        perms = sponge_perms(64 + msg.shape[1], 136, 64) + sponge_perms(128, 136, 64)
        meta_launch(where, mu_out, [slots, reqs], rows * perms * PERM_INT_OPS)
        return None
    check_cuda(where, slots)
    if rows:
        _launch(where, where, tr.data_ptr(), key.data_ptr(), msg.data_ptr(), msg.stride(0),
                msg.shape[1], rnd.data_ptr(), rnd.stride(0), slots.data_ptr(),
                reqs.data_ptr(), count.data_ptr(), mu_out.data_ptr(), rho_out.data_ptr(), rows)
    return None
