"""Modular arithmetic on the paper's 32-bit datapath, in PyTorch.

Every RNS prime is below 2^30, so every residue — including the lazy
[0, 2q) band — is below 2^31.  Residue stacks are therefore stored as
``torch.int32``, and the full-word constants (Shoup companions, Barrett
mu) as ``int32`` tensors holding the uint32 bit pattern.  The torch
helpers here take ``int64`` tensors that hold uint32 values (widen a
stack with ``.long()`` and a constant with ``u32(t)``) and emulate the
u32 lane exactly: products go through 16-bit limbs so nothing exceeds
2^63, and every step that wraps on a u32 lane is masked to 32 bits.  So
each helper returns the same representative as the device kernels
(``csrc/modarith.cuh``) and as the JAX reference's u32 datapath — not
just the same residue.

Contracts (all values uint32, q < 2^30):
  addmod/submod             a, b in [0, q)   ->  [0, q)
  lazy_addmod/lazy_submod   a, b in [0, 2q)  ->  [0, 2q)
  mulmod_shoup_lazy(x, ...) x any u32        ->  [0, 2q), == x*w mod q
  mulmod_shoup              x any u32        ->  [0, q)
  mulmod_barrett(_lazy)     a, b in [0, q)   ->  [0, q) ([0, 2q) lazy)

Each op has a numpy uint64 oracle (``*_np``), the test gold standard.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
MASK16 = 0xFFFF

# the CKKS RNS prime window: mu = 2^60/q fits u32, 2q < 2^31
BARRETT_WINDOW = (1 << 28, 1 << 30)
BARRETT_MU_SHIFT = 60
SHOUP_SHIFT = 32


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern tensor -> int64 tensor holding the uint32 value."""
    return t.long() & M32


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

def shoup_precompute(w: int, q: int) -> int:
    """w' = floor(w * 2^32 / q), the Shoup companion (the paper's TW')."""
    return (int(w) << SHOUP_SHIFT) // int(q)


def mulmod_shoup_lazy(x, w, wp, q):
    """Shoup multiply without the final subtract: [0, 2q), == x*w mod q."""
    return (mullo_u32(x, w) - mullo_u32(mulhi_u32(x, wp), q)) & M32


def mulmod_shoup(x, w, wp, q):
    """x * w mod q with the precomputed companion wp; result in [0, q)."""
    r = mulmod_shoup_lazy(x, w, wp, q)
    return torch.where(r >= q, r - q, r)


# -------------------------------------------------------------- Barrett

def barrett_precompute(q: int) -> int:
    """mu = floor(2^60 / q) for q inside the RNS Barrett window.

    A ``ValueError``, not an assert: under ``python -O`` an assert is
    stripped and an out-of-range q would silently yield a wrong mu."""
    q = int(q)
    lo, hi = BARRETT_WINDOW
    if not lo < q < hi:
        raise ValueError(
            f"barrett_precompute: q={q} outside the uint32-lane Barrett "
            f"range ({lo}, {hi}) exclusive — mu would be silently wrong")
    return (1 << BARRETT_MU_SHIFT) // q


def _barrett_r(a, b, q, mu):
    # approx = floor(P / 2^29) and qhat = floor(approx*mu / 2^31), both
    # assembled from the hi/lo halves exactly as the u32 lane does
    hi = mulhi_u32(a, b)
    lo = mullo_u32(a, b)
    approx = ((hi << 3) | (lo >> 29)) & M32
    qhat = ((mulhi_u32(approx, mu) << 1) | (mullo_u32(approx, mu) >> 31)) & M32
    return (lo - mullo_u32(qhat, q)) & M32                  # < 3q


def mulmod_barrett_lazy(a, b, q, mu):
    """Barrett product reduced to the [0, 2q) band (one subtract of 2q)."""
    r = _barrett_r(a, b, q, mu)
    q2 = q + q
    return torch.where(r >= q2, r - q2, r)


def mulmod_barrett(a, b, q, mu):
    """a * b mod q via Barrett reduction; inputs in [0, q)."""
    r = mulmod_barrett_lazy(a, b, q, mu)
    return torch.where(r >= q, r - q, r)


# ----------------------------------------------------------- Montgomery

def montgomery_precompute(q: int) -> tuple[int, int]:
    """(qinv_neg, r2) with qinv_neg = -q^{-1} mod 2^32, r2 = 2^64 mod q
    (only carried in ``NTTParams``; no port op uses Montgomery)."""
    qinv = pow(int(q), -1, 1 << 32)
    return ((1 << 32) - qinv) & M32, (1 << 64) % int(q)


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


def mulmod_shoup_lazy_np(x, w, q):
    """r = x*w - floor(x*wp / 2^32)*q mod 2^32, wp = floor(w*2^32/q)."""
    x = np.asarray(x, dtype=np.uint64)
    w = np.asarray(w, dtype=np.uint64)
    sh = np.uint64(SHOUP_SHIFT)
    wp = (w << sh) // np.uint64(q)
    hi = (x * wp) >> sh
    r = (x * w - hi * np.uint64(q)) & np.uint64(M32)
    return r.astype(np.uint32)


def mulmod_barrett_lazy_np(a, b, q):
    """The [0, 2q) Barrett representative: (a*b) mod q, plus q when the
    datapath's single 2q-subtract leaves the high copy."""
    a64 = np.asarray(a, dtype=np.uint64)
    b64 = np.asarray(b, dtype=np.uint64)
    mu = (1 << BARRETT_MU_SHIFT) // int(q)
    prod = a64 * b64
    approx = prod >> np.uint64(29)
    qhat = (approx * np.uint64(mu)) >> np.uint64(31)
    r = (prod - qhat * np.uint64(q)) & np.uint64(M32)
    q2 = np.uint64(2 * int(q))
    return (r - np.where(r >= q2, q2, np.uint64(0))).astype(np.uint32)
