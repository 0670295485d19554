"""Scheme-generic ring descriptors: the contract every scheme rides.

A ``RingSpec`` pins down everything the banks kernels need to know
about a polynomial ring R_q = Z_q[X]/(X^n + 1):

  * ``q`` / ``dtype``   — the modulus and the element lane width it
    rides in.  The accepted modulus window per dtype is the Barrett
    window of ``core.modmath`` (u32: (2^28, 2^30) CKKS RNS primes, or
    the 23-bit trait's (2^21, 2^23), e.g. ML-DSA's q=8380417; u16:
    (2^10, 2^12), e.g. ML-KEM's q=3329).
  * ``block``           — the basecase block size.  ``block=1`` is the
    COMPLETE transform (log2 n butterfly stages, pointwise products in
    the NTT domain).  ``block=2`` is the INCOMPLETE transform Kyber
    uses when 2n ∤ q-1: the stage loop stops one level early
    (``stages = log2 n − log2 block``), the NTT domain consists of
    n/2 degree-1 residues, and products need the degree-1 basecase
    multiplication with per-pair ζ factors (``dyadic_basemul_banks``).
  * ``zeta``            — an order-(2n/block) root of unity.  The
    twist X -> ζ^(1/n)·X is folded into the twiddle tree, so the
    kernels always run with ``negacyclic=False`` on ring packs.
  * ``lazy_band``       — the inter-stage band bound [0, 2q); on u16
    lanes 4q < 2^16 keeps lazy add/sub overflow-free, mirroring the
    u32 path's 4q < 2^32.

``ring_table_pack`` lowers a spec to the same stacked-table dict the
CKKS ``TablePack`` uses (``qs``/``tw``/``twp``/``itw``/``itwp``/
``ninv``/``mu``/zeroed ``psi`` rows), plus ``gamma``/``gammap`` — the
per-pair ζ factors of the incomplete basecase — as numpy arrays of the
spec's dtype; ``repro_torch.convert.from_reference`` moves them onto a
device (uint16 as int16 bit patterns).

Twiddle construction is the CG (Pease) tree recursion: the root node
is X^n − ζ^(ord/2) (ord = 2n/block); a node X^m − ζ^e splits into
X^(m/2) ∓ ζ^(e/2), and at CG stage t position j belongs to tree node
``j mod 2^t``.  The leaf exponents in CG pair order ARE the basecase
γ factors.  For ML-KEM (ζ=17) this gives γ_j = 17^(2·BitRev7(j)+1) in
CG order.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.modmath import (BARRETT_WINDOWS, barrett_bits,
                                      barrett_precompute, dtype_bits,
                                      shoup_precompute)
from repro_torch.core.params import root_of_unity

_NP_DTYPES = {"uint32": np.uint32, "uint16": np.uint16}


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Descriptor of one scheme's polynomial ring (see module docstring).

    ``zeta=None`` derives an order-(2n/block) root from the modulus;
    schemes with a pinned standard root (ML-KEM's 17) set it explicitly.
    """
    name: str                   # scheme tag, e.g. "mlkem"
    n: int                      # ring degree (power of two)
    q: int                      # modulus, inside the dtype's window
    dtype: str = "uint32"       # element lane dtype name
    block: int = 1              # basecase block; 1 = complete transform
    zeta: int | None = None     # order-(2n/block) root; None = derive

    def __post_init__(self):
        bits = dtype_bits(self.dtype)   # raises on unsupported dtype
        lo, hi = BARRETT_WINDOWS[bits]
        try:
            barrett_bits(self.q, bits)
        except ValueError:
            raise ValueError(
                f"RingSpec {self.name!r}: modulus q={self.q} outside the "
                f"{self.dtype} ring window ({lo}, {hi}) exclusive — the "
                f"{bits}-bit Barrett/lazy band contract does not hold") from None
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(
                f"RingSpec {self.name!r}: ring degree n={self.n} must be "
                f"a power of two >= 2")
        if self.block < 1 or self.block & (self.block - 1) \
                or self.block >= self.n:
            raise ValueError(
                f"RingSpec {self.name!r}: basecase block={self.block} "
                f"must be a power of two in [1, n={self.n})")
        order = 2 * self.n // self.block
        if (self.q - 1) % order != 0:
            raise ValueError(
                f"RingSpec {self.name!r}: modulus q={self.q} has no "
                f"order-{order} root (need 2n/block | q-1 for the "
                f"block={self.block} transform; q-1 = {self.q - 1})")
        if self.zeta is not None and not (
                pow(self.zeta, order, self.q) == 1
                and pow(self.zeta, order // 2, self.q) != 1):
            raise ValueError(
                f"RingSpec {self.name!r}: zeta={self.zeta} is not a "
                f"primitive order-{order} root mod q={self.q}")

    @property
    def bits(self) -> int:
        return dtype_bits(self.dtype)

    @property
    def barrett_bits(self) -> int:
        """The Barrett trait of the modulus (``modmath.barrett_bits``):
        the lane's width, or 23 for a 22- or 23-bit modulus on u32."""
        return barrett_bits(self.q, self.bits)

    @property
    def stages(self) -> int:
        """Butterfly stage count: log2(n) − log2(block)."""
        return self.n.bit_length() - self.block.bit_length()

    @property
    def incomplete(self) -> bool:
        return self.block > 1

    @property
    def lazy_band(self) -> int:
        """Exclusive upper bound of the inter-stage lazy band."""
        return 2 * self.q


# ML-KEM / FIPS 203: n=256, q=3329, incomplete depth-7 transform over
# 128 degree-1 residues, standard root zeta=17 of order 256.
MLKEM_RING = RingSpec(name="mlkem", n=256, q=3329, dtype="uint16",
                      block=2, zeta=17)

# ML-DSA / FIPS 204: n=256, q=8380417 (23 bits, the u32 lane's third
# Barrett window), the complete depth-8 transform, standard root
# zeta=1753 of order 512.
MLDSA_RING = RingSpec(name="mldsa", n=256, q=8380417, dtype="uint32",
                      block=1, zeta=1753)


def _tree_twiddles(spec: RingSpec, zeta: int):
    """CG-order twiddle rows + leaf gammas via the tree recursion."""
    n, q, order = spec.n, spec.q, 2 * spec.n // spec.block
    stages = spec.stages
    exps = [order // 2]                 # depth-0 node exponents
    tw = np.zeros((stages, n // 2), dtype=np.int64)
    for t in range(stages):
        for j in range(n // 2):
            tw[t, j] = pow(zeta, exps[j % (1 << t)] // 2, q)
        exps = [e for p in exps for e in (p // 2, p // 2 + order // 2)]
    gamma = np.array([pow(zeta, exps[j], q) for j in range(n // 2)],
                     dtype=np.int64)
    return tw, gamma, stages


@functools.lru_cache(maxsize=None)
def ring_table_pack(spec: RingSpec) -> dict[str, np.ndarray]:
    """Stacked single-ring table pack for the banks kernels.

    Same key layout as the CKKS ``TablePack`` (leading k=1 prime axis)
    plus the basecase rows, all numpy in the spec's element dtype:

      qs (1,)           tw/twp (1, stages, n/2)    itw/itwp likewise
      ninv/ninv_p (1,)  ninv = inverse of 2^stages (NOT n for block>1)
      psi/psip/ipsin/ipsinp (1, n)  zeros — the twist lives in the tree
      mu (1,)           Barrett mu of the modulus's trait (``barrett_bits``)
      gamma/gammap (1, n/2)  per-pair ζ factors of the degree-1 basecase

    The arrays are shared by every caller (the cache): do not write to
    them.
    """
    q, bits = spec.q, spec.bits
    zeta = spec.zeta if spec.zeta is not None \
        else root_of_unity(2 * spec.n // spec.block, q)
    tw, gamma, stages = _tree_twiddles(spec, zeta)
    itw = np.vectorize(lambda w: pow(int(w), q - 2, q))(tw)
    ninv = pow(1 << stages, q - 2, q)
    dt = _NP_DTYPES[spec.dtype]

    def sh(arr):
        return np.vectorize(
            lambda w: shoup_precompute(int(w), q, bits))(arr).astype(dt)

    return {
        "qs": np.array([q], dtype=dt),
        "tw": tw.astype(dt)[None],
        "twp": sh(tw)[None],
        "itw": itw.astype(dt)[None],
        "itwp": sh(itw)[None],
        "ninv": np.array([ninv], dtype=dt),
        "ninv_p": np.array([shoup_precompute(ninv, q, bits)], dtype=dt),
        "psi": np.zeros((1, spec.n), dtype=dt),
        "psip": np.zeros((1, spec.n), dtype=dt),
        "ipsin": np.zeros((1, spec.n), dtype=dt),
        "ipsinp": np.zeros((1, spec.n), dtype=dt),
        "mu": np.array([barrett_precompute(q, spec.barrett_bits)], dtype=dt),
        "gamma": gamma.astype(dt)[None],
        "gammap": sh(gamma)[None],
    }
