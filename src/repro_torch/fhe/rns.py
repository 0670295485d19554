"""Residue Number System substrate for CKKS (paper §VIII).

An ``RnsPoly`` is one stacked (k, n) int32 tensor of residue rows, one
row per prime, in coefficient or NTT (evaluation) form, on the device
its data lives on.  Ring ops are single vectorized modmath calls over
the whole stack, and the NTT/iNTT go through the multi-prime banks entry
points (``kernels.ops``), so the k rows transform in one kernel launch.

Base conversions are exact because digit decomposition uses
single-prime digits (alpha=1).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.convert import resolve_device, tensor_to_u32, u32_to_tensor
from repro_torch.core.modmath import (addmod, barrett_precompute,
                                      mulmod_barrett, mulmod_shoup,
                                      shoup_precompute, submod, u32)
from repro_torch.core.params import NTTParams, gen_ntt_primes, make_ntt_params
from repro_torch.fhe import batched as FB
from repro_torch.kernels import ops

_PACKS: dict = {}


@functools.lru_cache(maxsize=None)
def prime_params(n: int, q: int) -> NTTParams:
    """One prime's NTT tables over ring n (cached)."""
    return make_ntt_params(n, q=q)


def _cached(key, build):
    if key not in _PACKS:
        _PACKS[key] = build()
    return _PACKS[key]


def basis_pack(primes: tuple[int, ...], n: int, device) -> dict:
    """Stacked TablePack for a prime basis on ``device`` (cached)."""
    return _cached(("table", primes, n, str(device)),
                   lambda: FB.build_table_pack(primes, n, device))


def fourstep_basis_pack(primes: tuple[int, ...], n: int, device) -> dict:
    """FourStepPack for a prime basis on ``device`` (cached) — the tables
    of the large-N pipeline that rings with n >= ops.FOURSTEP_MIN_N use."""
    return _cached(("fourstep", primes, n, str(device)),
                   lambda: FB.build_fourstep_pack(primes, n, device))


def scalar_pack(primes: tuple[int, ...], device) -> dict:
    """Per-prime scalar rows (qs/mu/pinv/pinv_p) on ``device`` (cached)."""
    return _cached(("scalar", primes, str(device)),
                   lambda: FB.build_scalar_pack(primes, device))


@functools.lru_cache(maxsize=None)
def _basis_consts_np(primes: tuple[int, ...]):
    mus = [barrett_precompute(q) if (1 << 28) < q < (1 << 30) else 0
           for q in primes]
    return np.array(primes, dtype=np.int64), np.array(mus, dtype=np.int64)


def _basis_consts(primes: tuple[int, ...], device):
    """(k, 1) int64 columns of q and the Barrett mu per prime (cached)."""
    def build():
        qs, mus = _basis_consts_np(primes)
        return (torch.from_numpy(qs)[:, None].to(device),
                torch.from_numpy(mus)[:, None].to(device))
    return _cached(("consts", primes, str(device)), build)


@dataclasses.dataclass
class RnsPoly:
    """data: (len(primes), n) int32; NTT form iff is_ntt."""
    data: torch.Tensor
    primes: tuple[int, ...]
    is_ntt: bool

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def _q(self) -> torch.Tensor:
        return _basis_consts(self.primes, self.device)[0]

    def _like(self, data, is_ntt: bool | None = None) -> "RnsPoly":
        return RnsPoly(data, self.primes,
                       self.is_ntt if is_ntt is None else is_ntt)

    def _check(self, other: "RnsPoly", op: str):
        if self.primes != other.primes or self.is_ntt != other.is_ntt:
            raise ValueError(f"RnsPoly.{op}: operands differ in basis or form")

    def add(self, other: "RnsPoly") -> "RnsPoly":
        self._check(other, "add")
        return self._like(addmod(self.data.long(), other.data.long(), self._q).int())

    def sub(self, other: "RnsPoly") -> "RnsPoly":
        self._check(other, "sub")
        return self._like(submod(self.data.long(), other.data.long(), self._q).int())

    def mul(self, other: "RnsPoly") -> "RnsPoly":
        """Dyadic product — both operands must be in NTT form."""
        self._check(other, "mul")
        if not self.is_ntt:
            raise ValueError("RnsPoly.mul: operands must be in NTT form")
        qs, mus = _basis_consts(self.primes, self.device)
        return self._like(mulmod_barrett(self.data.long(), other.data.long(),
                                         qs, mus).int())

    def mul_scalar_per_prime(self, scalars: dict[int, int]) -> "RnsPoly":
        svals = np.array([scalars[q] % q for q in self.primes], dtype=np.uint32)
        sps = np.array([shoup_precompute(int(s), q)
                        for s, q in zip(svals, self.primes)], dtype=np.uint32)
        w = u32(u32_to_tensor(svals, self.device))[:, None]
        wp = u32(u32_to_tensor(sps, self.device))[:, None]
        return self._like(mulmod_shoup(self.data.long(), w, wp, self._q).int())

    def neg(self) -> "RnsPoly":
        d = self.data.long()
        return self._like(submod(torch.zeros_like(d), d, self._q).int())

    def to_ntt(self) -> "RnsPoly":
        """Negacyclic NTT of every residue row in one banks dispatch.
        Rings with n >= ``ops.FOURSTEP_MIN_N`` go through the four-step
        pipeline and hold natural-order NTT rows; smaller rings use the
        single kernel (bitrev order)."""
        if self.is_ntt:
            raise ValueError("RnsPoly.to_ntt: already in NTT form")
        if self.n >= ops.FOURSTEP_MIN_N:
            fp = fourstep_basis_pack(self.primes, self.n, self.device)
            return self._like(ops.ntt_fourstep_banks(self.data, fp), True)
        t = basis_pack(self.primes, self.n, self.device)
        return self._like(ops.ntt_banks(self.data, t), True)

    def to_coeff(self) -> "RnsPoly":
        if not self.is_ntt:
            raise ValueError("RnsPoly.to_coeff: already in coefficient form")
        if self.n >= ops.FOURSTEP_MIN_N:
            fp = fourstep_basis_pack(self.primes, self.n, self.device)
            return self._like(ops.intt_fourstep_banks(self.data, fp), False)
        t = basis_pack(self.primes, self.n, self.device)
        return self._like(ops.intt_banks(self.data, t), False)

    def automorphism(self, idx) -> "RnsPoly":
        """NTT-domain Galois automorphism: one gather over the stack
        (``ops.galois_banks``); idx from ``core.params.galois_eval_perm``
        for this ring's frequency order."""
        if not self.is_ntt:
            raise ValueError("RnsPoly.automorphism: NTT form expected")
        return self._like(ops.galois_banks(self.data, idx))

    def drop_last(self) -> "RnsPoly":
        return RnsPoly(self.data[:-1], self.primes[:-1], self.is_ntt)


# ------------------------------------------------------- constructions

def from_int_coeffs(coeffs, primes: tuple[int, ...], n: int, device) -> RnsPoly:
    """coeffs: numpy object/int array of (possibly negative) integers."""
    coeffs = np.asarray(coeffs, dtype=object)
    rows = np.stack([(coeffs % q).astype(np.uint64).astype(np.uint32)
                     for q in primes])
    return RnsPoly(u32_to_tensor(rows, device), tuple(primes), False)


def uniform_ntt(rng: np.random.Generator, primes, n: int, device) -> RnsPoly:
    """Uniform ring element, sampled directly in NTT form."""
    rows = np.stack([rng.integers(0, q, size=n, dtype=np.uint32)
                     for q in primes])
    return RnsPoly(u32_to_tensor(rows, device), tuple(primes), True)


def gaussian_coeffs(rng: np.random.Generator, n: int, sigma: float = 3.2) -> np.ndarray:
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def ternary_coeffs(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(-1, 2, size=n).astype(np.int64)


# ---------------------------------------------------- base conversions

def center_row(row, q: int) -> np.ndarray:
    """uint32 residues -> centered int64 in [-q/2, q/2]."""
    r = np.asarray(row).astype(np.int64)
    return np.where(r > q // 2, r - q, r)


def extend_single(row, src_q: int, dst_primes: tuple[int, ...], device=None) -> RnsPoly:
    """EXACT base conversion of one centered residue row mod ``src_q`` to
    ``dst_primes`` (the alpha=1 mod-up of the paper's Fig 22), on the
    host: ``row`` is a uint32 numpy row; the result, in coefficient
    form, lands on ``device`` (the card unless the caller asks for
    another)."""
    c = center_row(row, src_q)
    rows = np.stack([(((c % q) + q) % q).astype(np.uint32) for q in dst_primes])
    return RnsPoly(u32_to_tensor(rows, resolve_device(device)), tuple(dst_primes), False)


def crt_reconstruct_centered(poly: RnsPoly) -> np.ndarray:
    """(k, n) residues -> centered big-int numpy object array (host CRT)."""
    if poly.is_ntt:
        raise ValueError("crt_reconstruct_centered: coefficient form expected")
    primes = poly.primes
    Q = 1
    for q in primes:
        Q *= q
    acc = np.zeros(poly.n, dtype=object)
    for row, q in zip(tensor_to_u32(poly.data), primes):
        Qi = Q // q
        t = pow(Qi % q, -1, q)
        acc += row.astype(object) * (Qi * t)
    acc %= Q
    return np.where(acc > Q // 2, acc - Q, acc)


def centered_to_float(big: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Centered big-int object array -> float64, divided by ``scale``.
    One C-level cast in the common case; past float64 range each value is
    shifted down to a 64-bit mantissa and rescaled with ``ldexp``."""
    try:
        return big.astype(np.float64) / scale
    except OverflowError:
        def lift(x):
            a = -x if x < 0 else x
            sh = max(0, a.bit_length() - 64)
            try:
                v = math.ldexp(float(a >> sh) / scale, sh)
            except OverflowError:         # x/scale itself beyond float64
                v = math.inf
            return -v if x < 0 else v
        return np.array([lift(int(x)) for x in big])


def make_primes(n: int, count: int, bits: int = 30) -> list[int]:
    return gen_ntt_primes(count, n, bits=bits)
