"""FIPS 203's byte codecs as tensor operations over leading batch dims,
for ML-KEM-768's ring (n = 256, q = 3329): ByteEncode / ByteDecode
(Alg. 5, 6), Compress / Decompress, and the 12-bit codec in the port's
CG order of the NTT domain.  Used by ``pq.mlkem`` (key generation,
decryption) and by the plain versions of the codec kernels
(``kernels.ref``), which run the encapsulation's codec on the card."""
from __future__ import annotations

import functools
import math

import torch

N = 256
Q = 3329


@functools.lru_cache(maxsize=None)
def _steps(device: str, step: int, count: int) -> torch.Tensor:
    """step * arange(count), int64, on ``device`` (one copy a device)."""
    return torch.arange(0, step * count, step, dtype=torch.int64, device=device)


def _geometry(d: int) -> tuple[int, int]:
    """(coefficients, bytes) of one ByteEncode_d group: lcm(d, 8) bits."""
    bits = math.lcm(d, 8)
    return bits // d, bits // 8


def byte_encode(d: int, f: torch.Tensor) -> torch.Tensor:
    """ByteEncode_d, d < 12: (..., 256) integers below 2^d in natural
    order -> (..., 32 * d) uint8.  A group of lcm(d, 8) bits is packed
    into an int64 and its low bytes read as they lie (little-endian)."""
    per, nb = _geometry(d)
    g = f.long().unflatten(-1, (N // per, per))
    w = g[..., 0]
    for k in range(1, per):
        w = w | (g[..., k] << (d * k))
    return w.unsqueeze(-1).view(torch.uint8)[..., :nb].flatten(-2).contiguous()


def byte_decode(d: int, buf: torch.Tensor) -> torch.Tensor:
    """ByteDecode_d, d < 12: (..., 32 * d) bytes -> (..., 256) int64
    below 2^d.  A group's bytes, padded to 8, read as an int64."""
    per, nb = _geometry(d)
    groups = torch.nn.functional.pad(buf.unflatten(-1, (-1, nb)), (0, 8 - nb))
    w = groups.view(torch.int64)                        # (..., groups, 1)
    return ((w >> _steps(str(buf.device), d, per)) & ((1 << d) - 1)).flatten(-2)


def decode12(buf: torch.Tensor) -> torch.Tensor:
    """The 12-bit fields of (..., 384) bytes in CG order, as int32 below
    2^12: byte triple t holds FIPS coefficients 2t and 2t + 1, CG
    positions t and 128 + t.  ByteDecode12 is this mod q."""
    t = buf.unflatten(-1, (N // 2, 3)).int()
    return torch.cat([t[..., 0] | ((t[..., 1] & 15) << 8),
                      (t[..., 1] >> 4) | (t[..., 2] << 4)], -1)


def mod_q(x: torch.Tensor) -> torch.Tensor:
    """Fields below 2^12 < 2q reduced mod q, as int16 residues."""
    return torch.where(x < Q, x, x - Q).to(torch.int16)


def encode12(x: torch.Tensor) -> torch.Tensor:
    """ByteEncode12 of (..., 256) canonical residues in CG order ->
    (..., 384) uint8."""
    v = x.int()
    w = v[..., :N // 2] | (v[..., N // 2:] << 12)       # a triple's 24 bits
    return w.unsqueeze(-1).view(torch.uint8)[..., :3].flatten(-2).contiguous()


def compress(d: int, x: torch.Tensor) -> torch.Tensor:
    """round(2^d / q * x) mod 2^d for canonical x (FIPS 203 Compress)."""
    return (((x.int() << (d + 1)) + Q) // (2 * Q)) & ((1 << d) - 1)


def decompress(d: int, y: torch.Tensor) -> torch.Tensor:
    """round(q / 2^d * y); output canonical in [0, q)."""
    return (Q * y.int() + (1 << (d - 1))) >> d


# ----------------------------------------------- FIPS 204 (ML-DSA-65)
# ML-DSA-65's parameters (FIPS 204 Table 1) and its codecs as tensor
# operations: the bit packings of keys and signatures, Power2Round and
# Decompose.  Used by ``pq.mldsa`` (key generation, the key's decode)
# and by the plain versions of the ML-DSA kernels (``kernels.ref``).

DSA_Q = 8380417
DSA_K, DSA_L = 6, 5
DSA_D = 13
DSA_ETA = 4
DSA_TAU = 49
DSA_GAMMA1 = 1 << 19
DSA_GAMMA2 = (DSA_Q - 1) // 32
DSA_BETA = DSA_TAU * DSA_ETA
DSA_OMEGA = 55
DSA_CT_BYTES = 48                      # c-tilde: lambda / 4
DSA_Z_BITS = 20                        # bitlen(2 gamma1 - 1)
DSA_W1_BITS = 4                        # bitlen((q - 1) / (2 gamma2) - 1)
DSA_T1_BITS = 10                       # bitlen(q - 1) - d
DSA_ETA_BITS = 4                       # bitlen(2 eta)
DSA_SIG_BYTES = DSA_CT_BYTES + 32 * DSA_L * DSA_Z_BITS + DSA_OMEGA + DSA_K   # 3309


def pack_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """FIPS 204 SimpleBitPack: (..., n) integers below 2^bits -> (..., n *
    bits / 8) uint8, coefficient i in bits [bits * i, bits * (i + 1)),
    least significant first."""
    dev = v.device
    b = (v.long().unsqueeze(-1) >> torch.arange(bits, device=dev)) & 1
    b = b.flatten(-2).unflatten(-1, (-1, 8))
    return (b << torch.arange(8, device=dev)).sum(-1).to(torch.uint8)


def unpack_bits(buf: torch.Tensor, bits: int) -> torch.Tensor:
    """FIPS 204 SimpleBitUnpack: (..., m) bytes -> (..., 8 m / bits) int64."""
    dev = buf.device
    b = (buf.long().unsqueeze(-1) >> torch.arange(8, device=dev)) & 1
    b = b.flatten(-2).unflatten(-1, (-1, bits))
    return (b << torch.arange(bits, device=dev)).sum(-1)


def centered(x: torch.Tensor, q: int = DSA_Q) -> torch.Tensor:
    """Residues in [0, q) -> x mod± q, in [-(q - 1) / 2, (q - 1) / 2]."""
    x = x.long()
    return torch.where(x > (q - 1) // 2, x - q, x)


def power2round(r: torch.Tensor):
    """FIPS 204 Alg. 35 of residues in [0, q): (r1, r0), r0 in (-2^12, 2^12]."""
    r = r.long()
    half = 1 << (DSA_D - 1)
    r0 = r & ((1 << DSA_D) - 1)
    r0 = torch.where(r0 > half, r0 - (1 << DSA_D), r0)
    return (r - r0) >> DSA_D, r0


def decompose(r: torch.Tensor):
    """FIPS 204 Alg. 36 of residues in [0, q): (r1 in [0, 16), r0)."""
    r = r.long()
    a = 2 * DSA_GAMMA2
    r0 = r % a
    r0 = torch.where(r0 > DSA_GAMMA2, r0 - a, r0)
    top = r - r0 == DSA_Q - 1
    return torch.where(top, 0, (r - r0) // a), torch.where(top, r0 - 1, r0)
