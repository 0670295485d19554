"""Modular arithmetic on the paper's datapath, in PyTorch, for two lanes.

The RNS lane (32 bits): every RNS prime is below 2^30, so every residue
— including the lazy [0, 2q) band — is below 2^31.  Residue stacks are
stored as ``torch.int32``, and the full-word constants (Shoup
companions, Barrett mu) as ``int32`` tensors holding the uint32 bit
pattern.  The small-ring lane (16 bits, ML-KEM's q = 3329): residues
and the lazy band fit ``torch.int16`` (4q < 2^15), and the Shoup
companions floor(w * 2^16 / q), up to 65535, ride as int16 bit
patterns.

The torch helpers here take ``int64`` tensors that hold the lane's
unsigned values (widen a stack with ``.long()`` and a constant with
``u32(t)`` or ``u16(t)``) and emulate the lane exactly.  On the 32-bit
lane products go through 16-bit limbs so nothing exceeds 2^63, and
every step that wraps on a u32 lane is masked to 32 bits.  The 16-bit
lane (``bits=16``) computes in u32 as the reference does — a 16x16
product is exact there — and truncates its result to 16 bits.  So each
helper returns the same representative as the device kernels
(``csrc/modarith.cuh``) and as the JAX reference's datapath — not just
the same residue.

Contracts (all values unsigned on the lane; q < 2^30, or in
(2^10, 2^12) for bits=16):
  addmod/submod             a, b in [0, q)   ->  [0, q)
  lazy_addmod/lazy_submod   a, b in [0, 2q)  ->  [0, 2q)
  mulmod_shoup_lazy(x, ...) x any lane value ->  [0, 2q), == x*w mod q
  mulmod_shoup              x any lane value ->  [0, q)
  mulmod_barrett(_lazy)     a, b in [0, q)   ->  [0, q) ([0, 2q) lazy)

Each op has a numpy uint64 oracle (``*_np``), the test gold standard.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
MASK16 = 0xFFFF

# accepted modulus window per lane width: bits -> (lo, hi), exclusive.
# 32: the CKKS RNS prime range (mu = 2^60/q fits u32, 2q < 2^31).
# 16: mu = 2^26/q fits u16 needs q > 2^10; the Barrett error bound and
#     the u16 lazy band (4q < 2^16) need q < 2^12.
BARRETT_WINDOWS = {32: (1 << 28, 1 << 30), 16: (1 << 10, 1 << 12)}
BARRETT_MU_SHIFTS = {32: 60, 16: 26}
SHOUP_SHIFTS = {32: 32, 16: 16}
BARRETT_WINDOW = BARRETT_WINDOWS[32]
BARRETT_MU_SHIFT = BARRETT_MU_SHIFTS[32]
SHOUP_SHIFT = SHOUP_SHIFTS[32]

_DTYPE_BITS = {"uint32": 32, "uint16": 16}


def dtype_bits(dtype) -> int:
    """Lane width in bits for a ring element dtype name ("uint32",
    "uint16") or numpy dtype."""
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPE_BITS:
        raise ValueError(
            f"dtype_bits: unsupported ring element dtype {name!r} "
            f"(expected one of {sorted(_DTYPE_BITS)})")
    return _DTYPE_BITS[name]


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern tensor -> int64 tensor holding the uint32 value."""
    return t.long() & M32


def u16(t: torch.Tensor) -> torch.Tensor:
    """int16 bit-pattern tensor -> int64 tensor holding the uint16 value."""
    return t.long() & MASK16


def _check_bits(where: str, bits: int, table: dict) -> None:
    if bits not in table:
        raise ValueError(f"{where}: unsupported lane width {bits} "
                         f"(expected one of {sorted(table)})")


# ---------------------------------------------------------------- limbs

def mulhi_u32(a, b):
    """High 32 bits of a 32x32 product, exact for a, b < 2^32: split a
    into 16-bit limbs so each partial product stays below 2^48."""
    a0 = a & MASK16
    a1 = a >> 16
    return (a1 * b + ((a0 * b) >> 16)) >> 16


def mullo_u32(a, b):
    """Low 32 bits of a 32x32 product (the u32 lane's wrapping multiply)."""
    a0 = a & MASK16
    a1 = a >> 16
    return ((((a1 * b) & MASK16) << 16) + a0 * b) & M32


# ------------------------------------------------------------- add/sub

def addmod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    return torch.where(a >= b, a - b, a + (q - b))


def lazy_addmod(a, b, q):
    """(a + b) keeping the [0, 2q) lazy invariant (one subtract of 2q)."""
    q2 = q + q
    s = a + b
    return torch.where(s >= q2, s - q2, s)


def lazy_submod(a, b, q):
    """(a - b) keeping the [0, 2q) lazy invariant (borrow adds 2q)."""
    q2 = q + q
    return torch.where(a >= b, a - b, a + (q2 - b))


# ---------------------------------------------------------------- Shoup

def shoup_precompute(w: int, q: int, bits: int = 32) -> int:
    """w' = floor(w * 2^bits / q), the Shoup companion (the paper's TW');
    ``bits`` is the lane width (32 for RNS primes, 16 for small rings)."""
    _check_bits("shoup_precompute", bits, SHOUP_SHIFTS)
    return (int(w) << SHOUP_SHIFTS[bits]) // int(q)


def _shoup16_r(x, w, wp, q):
    # the 16-bit lane in u32: x*w and x*wp are exact for u16 operands, so
    # the Shoup hi-part is a plain shift; r = x*w - hi*q lands in [0, 2q)
    return (x * w - ((x * wp) >> 16) * q) & M32


def mulmod_shoup_lazy(x, w, wp, q, bits: int = 32):
    """Shoup multiply without the final subtract: [0, 2q), == x*w mod q."""
    if bits == 16:
        return _shoup16_r(x, w, wp, q) & MASK16
    return (mullo_u32(x, w) - mullo_u32(mulhi_u32(x, wp), q)) & M32


def mulmod_shoup(x, w, wp, q, bits: int = 32):
    """x * w mod q with the precomputed companion wp; result in [0, q)."""
    if bits == 16:
        r = _shoup16_r(x, w, wp, q)
        return torch.where(r >= q, r - q, r) & MASK16
    r = mulmod_shoup_lazy(x, w, wp, q)
    return torch.where(r >= q, r - q, r)


# -------------------------------------------------------------- Barrett

def barrett_precompute(q: int, bits: int = 32) -> int:
    """mu = floor(2^s / q) for q inside the lane's Barrett window:
    s = 60, window (2^28, 2^30) for bits=32; s = 26, window (2^10, 2^12)
    for bits=16.

    A ``ValueError``, not an assert: under ``python -O`` an assert is
    stripped and an out-of-range q would silently yield a wrong mu."""
    q = int(q)
    _check_bits("barrett_precompute", bits, BARRETT_WINDOWS)
    lo, hi = BARRETT_WINDOWS[bits]
    if not lo < q < hi:
        raise ValueError(
            f"barrett_precompute: q={q} outside the uint{bits}-lane "
            f"Barrett range ({lo}, {hi}) exclusive — mu would be silently "
            f"wrong")
    return (1 << BARRETT_MU_SHIFTS[bits]) // q


def _barrett16_r(a, b, q, mu):
    # the 16-bit lane in u32: P = a*b, qhat = ((P >> 10) * mu) >> 16,
    # r = P - qhat*q < 2q for inputs in [0, q)
    prod = (a * b) & M32
    qhat = (((prod >> 10) * mu) & M32) >> 16
    return (prod - qhat * q) & M32


def _barrett_r(a, b, q, mu):
    # approx = floor(P / 2^29) and qhat = floor(approx*mu / 2^31), both
    # assembled from the hi/lo halves exactly as the u32 lane does
    hi = mulhi_u32(a, b)
    lo = mullo_u32(a, b)
    approx = ((hi << 3) | (lo >> 29)) & M32
    qhat = ((mulhi_u32(approx, mu) << 1) | (mullo_u32(approx, mu) >> 31)) & M32
    return (lo - mullo_u32(qhat, q)) & M32                  # < 3q


def mulmod_barrett_lazy(a, b, q, mu, bits: int = 32):
    """Barrett product reduced to the [0, 2q) band (one subtract of 2q)."""
    r = _barrett16_r(a, b, q, mu) if bits == 16 else _barrett_r(a, b, q, mu)
    q2 = q + q
    r = torch.where(r >= q2, r - q2, r)
    return r & MASK16 if bits == 16 else r


def mulmod_barrett(a, b, q, mu, bits: int = 32):
    """a * b mod q via Barrett reduction; inputs in [0, q)."""
    if bits == 16:
        r = _barrett16_r(a, b, q, mu)
        r = torch.where(r >= q + q, r - (q + q), r)
        return torch.where(r >= q, r - q, r) & MASK16
    r = mulmod_barrett_lazy(a, b, q, mu)
    return torch.where(r >= q, r - q, r)


# ----------------------------------------------------------- Montgomery

def montgomery_precompute(q: int) -> tuple[int, int]:
    """(qinv_neg, r2) with qinv_neg = -q^{-1} mod 2^32, r2 = 2^64 mod q."""
    qinv = pow(int(q), -1, 1 << 32)
    return ((1 << 32) - qinv) & M32, (1 << 64) % int(q)


def montmul(a, b, q, qinv_neg):
    """Montgomery product a*b*2^-32 mod q (inputs < q, q < 2^31 odd):
    the paper's Table II multiplier, the one it rejected for the BU."""
    hi = mulhi_u32(a, b)
    lo = mullo_u32(a, b)
    m = mullo_u32(lo, qinv_neg)
    t = hi + mulhi_u32(m, q) + (lo != 0).long()       # < 2q + 1 < 2^32
    return torch.where(t >= q, t - q, t)


def mulmod_montgomery(a, b, q, qinv_neg, r2):
    """a*b mod q through the Montgomery domain and back: the conversion
    overhead the paper cites as its reason to reject Montgomery."""
    am = montmul(a, r2, q, qinv_neg)                  # to Montgomery domain
    return montmul(am, b, q, qinv_neg)                # = a*b mod q (back out)


# ------------------------------------------------------- numpy oracles

def mulmod_np(a, b, q):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a * b) % np.uint64(q)).astype(np.uint32)


def addmod_np(a, b, q):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a + b) % np.uint64(q)).astype(np.uint32)


def submod_np(a, b, q):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a + np.uint64(q) - b) % np.uint64(q)).astype(np.uint32)


def mulhi_np(a, b):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a * b) >> np.uint64(32)).astype(np.uint32)


# Lazy oracles: exact uint64 models of the deterministic lazy-band
# representatives (not just the residue class).

def lazy_addmod_np(a, b, q):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    q2 = np.uint64(2 * int(q))
    s = a + b
    return (s - np.where(s >= q2, q2, np.uint64(0))).astype(np.uint32)


def lazy_submod_np(a, b, q):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    q2 = np.uint64(2 * int(q))
    return (a + np.where(a >= b, np.uint64(0), q2) - b).astype(np.uint32)


def mulmod_shoup_lazy_np(x, w, q, bits=32):
    """r = x*w - floor(x*wp / 2^S)*q mod 2^32, wp = floor(w*2^S/q), S the
    lane's Shoup shift (32 or 16).  The 16-bit lane's product is exact
    in u64, so the mask changes nothing there."""
    x = np.asarray(x, dtype=np.uint64)
    w = np.asarray(w, dtype=np.uint64)
    sh = np.uint64(SHOUP_SHIFTS[bits])
    wp = (w << sh) // np.uint64(q)
    hi = (x * wp) >> sh
    r = (x * w - hi * np.uint64(q)) & np.uint64(M32)
    return r.astype(np.uint32)


def mulmod_barrett_lazy_np(a, b, q, bits=32):
    """The [0, 2q) Barrett representative: (a*b) mod q, plus q when the
    datapath's single 2q-subtract leaves the high copy."""
    a64 = np.asarray(a, dtype=np.uint64)
    b64 = np.asarray(b, dtype=np.uint64)
    mu = (1 << BARRETT_MU_SHIFTS[bits]) // int(q)
    prod = a64 * b64
    if bits == 16:
        qhat = ((prod >> np.uint64(10)) * np.uint64(mu)) >> np.uint64(16)
    else:
        qhat = ((prod >> np.uint64(29)) * np.uint64(mu)) >> np.uint64(31)
    r = (prod - qhat * np.uint64(q)) & np.uint64(M32)
    q2 = np.uint64(2 * int(q))
    return (r - np.where(r >= q2, q2, np.uint64(0))).astype(np.uint32)
