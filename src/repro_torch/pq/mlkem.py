"""Batched ML-KEM-768 (FIPS 203) on the port's banks kernels.

The second scheme of the port: every polynomial transform and product
routes through the SAME kernel entry points the CKKS stack uses —
``ops.ntt_banks`` / ``ops.intt_banks`` for the incomplete n=256/q=3329
transform (7 stages, on the int16 lane: ``ntt_fwd_banks_u16`` /
``ntt_inv_banks_u16`` on the card) and ``ops.dyadic_basemul_banks`` for
the degree-1 basecase products — under the ``core.ringspec.MLKEM_RING``
descriptor.  Host numpy and ``hashlib`` handle only hashing, samplers
and byte codecs, as in the reference.

Host and device: the NTT-domain algebra — transforms, basemuls, the
K-term sums, ``+ e1``, ``+ e2 + mu`` and ``v − w`` — runs on the entry
point's device as int16/int64 tensors.  Arrays cross between host and
device only where a sampler's or a decoder's output goes in and where
an encoder's input comes out.  ``device=None`` means the card;
``device="cpu"`` runs the same code on the kernels' plain versions and
gives the same bytes.

Batching: every public entry point is batched over a leading ``(b,)``
axis of independent requests.  All the polynomial rows of a batch — k
vector entries, k×k matrix entries — fold into ONE kernel launch per
algebraic step, so a b=64 keygen runs its 384 CBD polynomials through
exactly one forward-NTT launch and its 576 matrix products through one
basemul launch.

Orders and domains: coefficient-domain polynomials are plain natural
order.  The CG-network NTT emits the 128 degree-1 residues in CG pair
order — pair j lives at (x[j], x[j+128]) with per-pair factor γ_j —
while FIPS 203 interleaves them as adjacent pairs of a bit-reversed
sequence.  The two orders differ by the fixed permutation
``fips[2*b + p] = cg[(p << 7) | b]``; it is applied ONLY at the
ByteEncode12/ByteDecode12 boundaries (and to SampleNTT output), so
serialized keys/ciphertexts are bit-exact FIPS 203 while all internal
NTT-domain arithmetic stays in CG order.

Only honest (self-generated) encapsulation keys are expected here; the
FIPS 203 encaps input checks (type/modulus check on ek) are not
re-validated per call.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.convert import from_reference, resolve_device
from repro_torch.core.ringspec import MLKEM_RING, ring_table_pack
from repro_torch.kernels import ops

K = 3                       # ML-KEM-768 module rank
ETA1 = 2
ETA2 = 2
DU = 10
DV = 4
N = MLKEM_RING.n            # 256
Q = MLKEM_RING.q            # 3329

EK_BYTES = 384 * K + 32     # 1184
DK_BYTES = 768 * K + 96     # 2400
CT_BYTES = 32 * (DU * K + DV)   # 1088


def _perms():
    perm = np.zeros(N, dtype=np.int64)
    for b in range(N // 2):
        for p in range(2):
            perm[2 * b + p] = (p << 7) | b
    return perm, np.argsort(perm)


_TO_FIPS, _TO_CG = _perms()     # fips = cg[_TO_FIPS]; cg = fips[_TO_CG]


# ------------------------------------------------------------- hashing

def _g(data: bytes) -> tuple[bytes, bytes]:
    d = hashlib.sha3_512(data).digest()
    return d[:32], d[32:]


def _h(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


def _j(data: bytes) -> bytes:
    return hashlib.shake_256(data).digest(32)


def _prf(eta: int, s: bytes, b: int) -> bytes:
    return hashlib.shake_256(s + bytes([b])).digest(64 * eta)


# ------------------------------------------------------------ samplers

def _sample_ntt(rho: bytes, j: int, i: int) -> np.ndarray:
    """Uniform NTT-domain polynomial from XOF(rho ‖ j ‖ i), FIPS order.

    Rejection-samples 12-bit candidates from SHAKE128 3 bytes at a
    time; SHAKE's prefix property lets us re-squeeze a longer digest on
    the (rare) shortage instead of streaming."""
    xof = hashlib.shake_128(rho + bytes([j, i]))
    need = 3 * 168                      # one squeeze block's worth
    while True:
        buf = np.frombuffer(xof.digest(need), dtype=np.uint8)
        b0 = buf[0::3].astype(np.int64)
        b1 = buf[1::3].astype(np.int64)
        b2 = buf[2::3].astype(np.int64)
        m = min(len(b0), len(b1), len(b2))
        d1 = b0[:m] + 256 * (b1[:m] & 0xF)
        d2 = (b1[:m] >> 4) + 16 * b2[:m]
        cand = np.stack([d1, d2], axis=-1).reshape(-1)
        acc = cand[cand < Q]
        if len(acc) >= N:
            return acc[:N].astype(np.uint16)
        need *= 2


def _cbd(eta: int, buf: bytes) -> np.ndarray:
    """Centered binomial sample from 64*eta PRF bytes, mod q."""
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                         bitorder="little").reshape(N, 2 * eta)
    x = bits[:, :eta].sum(axis=1, dtype=np.int64)
    y = bits[:, eta:].sum(axis=1, dtype=np.int64)
    return ((x - y) % Q).astype(np.uint16)


# ---------------------------------------------------------- byte codecs

def byte_encode(d: int, f: np.ndarray) -> np.ndarray:
    """FIPS 203 ByteEncode_d over leading batch dims: (..., 256) ints
    < 2^d -> (..., 32*d) bytes, little-endian bit packing."""
    f = np.asarray(f, dtype=np.uint32)
    bits = ((f[..., :, None] >> np.arange(d)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(f.shape[:-1] + (N * d,)),
                       axis=-1, bitorder="little")


def byte_decode(d: int, buf: np.ndarray) -> np.ndarray:
    """FIPS 203 ByteDecode_d: (..., 32*d) bytes -> (..., 256) ints."""
    buf = np.asarray(buf, dtype=np.uint8)
    bits = np.unpackbits(buf, axis=-1, bitorder="little")
    bits = bits.reshape(buf.shape[:-1] + (N, d)).astype(np.int64)
    return (bits << np.arange(d)).sum(axis=-1)


def compress(d: int, x: np.ndarray) -> np.ndarray:
    """round(2^d / q * x) mod 2^d for canonical x (FIPS 203 Compress)."""
    x = np.asarray(x, dtype=np.int64)
    return (((x << (d + 1)) + Q) // (2 * Q)) % (1 << d)


def decompress(d: int, y: np.ndarray) -> np.ndarray:
    """round(q / 2^d * y); output canonical in [0, q)."""
    y = np.asarray(y, dtype=np.int64)
    return (Q * y + (1 << (d - 1))) >> d


# ------------------------------------------------ host <-> device moves

def _dev(x: np.ndarray, device) -> torch.Tensor:
    """Canonical host residues (< q, any integer dtype) -> int16 tensor."""
    return torch.from_numpy(x.astype(np.int16)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """Canonical device residues -> int64 numpy on the host."""
    return t.cpu().numpy().astype(np.int64)


# ------------------------------------------- kernel-routed ring algebra

_PACKS: dict = {}


def _pack(device) -> dict:
    """``ring_table_pack(MLKEM_RING)`` as int16 tensors on ``device``,
    moved once per device."""
    key = str(device)
    if key not in _PACKS:
        _PACKS[key] = from_reference(ring_table_pack(MLKEM_RING), device)
    return _PACKS[key]


def _ntt_rows(x: torch.Tensor) -> torch.Tensor:
    """Forward incomplete NTT of every (..., 256) int16 row in ONE banks
    launch (natural coefficients in, CG NTT domain out)."""
    out = ops.ntt_banks(x.reshape(1, -1, N), _pack(x.device), negacyclic=False)
    return out.reshape(x.shape)


def _intt_rows(x: torch.Tensor) -> torch.Tensor:
    """Inverse incomplete NTT (CG NTT domain in, natural coeffs out)."""
    out = ops.intt_banks(x.reshape(1, -1, N), _pack(x.device), negacyclic=False)
    return out.reshape(x.shape)


def _basemul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Degree-1 basecase products of every row pair in ONE launch."""
    out = ops.dyadic_basemul_banks(a.reshape(1, -1, N), b.reshape(1, -1, N),
                                   _pack(a.device))
    return out.reshape(a.shape)


def _matvec_hat(a_hat: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """(Â ∘ ŷ)[i] = Σ_j Â[i][j] ⊛ ŷ[j], all CG NTT domain.

    a_hat: (b, K, K, 256); y_hat: (b, K, 256).  All b*K*K basecase
    products run as one kernel launch (``ops`` copies the broadcast
    right-hand side, and a transposed Â, to contiguous stacks first);
    the K-term sums are int64 adds mod q on the device."""
    bsz = a_hat.shape[0]
    rhs = y_hat[:, None].expand(bsz, K, K, N)
    prods = _basemul_rows(a_hat, rhs).long()
    return (prods.sum(dim=2) % Q).to(torch.int16)


def _dot_hat(t_hat: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """(t̂ᵀ ∘ ŷ) = Σ_j t̂[j] ⊛ ŷ[j]: (b, K, 256) x (b, K, 256) ->
    (b, 256), one basemul launch + device sum."""
    prods = _basemul_rows(t_hat, y_hat).long()
    return (prods.sum(dim=1) % Q).to(torch.int16)


# --------------------------------------------------------- K-PKE layers

def _expand_a(rhos: list[bytes]) -> np.ndarray:
    """Matrix Â per batch item, SampleNTT(ρ ‖ j ‖ i) converted to CG
    order: (b, K, K, 256) uint16 on the host."""
    a = np.empty((len(rhos), K, K, N), dtype=np.uint16)
    for bi, rho in enumerate(rhos):
        for i in range(K):
            for j in range(K):
                a[bi, i, j] = _sample_ntt(rho, j, i)
    return a[..., _TO_CG]


def _cbd_vector(eta: int, seeds: list[bytes], n0: int) -> np.ndarray:
    """(b, K, 256) of CBD_eta(PRF(seed, n0 + i)) rows on the host."""
    out = np.empty((len(seeds), K, N), dtype=np.uint16)
    for bi, s in enumerate(seeds):
        for i in range(K):
            out[bi, i] = _cbd(eta, _prf(eta, s, n0 + i))
    return out


def _k_pke_encrypt(ek: np.ndarray, m: np.ndarray, r: list[bytes],
                   device) -> np.ndarray:
    """Batched K-PKE.Encrypt: ek (b, 1184) u8, m (b, 32) u8 messages,
    r per-item randomness seeds.  Returns ct (b, 1088) u8."""
    bsz = ek.shape[0]
    t_hat = _dev((byte_decode(12, ek[:, :384 * K].reshape(bsz, K, 384))
                  % Q)[..., _TO_CG], device)
    a_hat = _dev(_expand_a([ek[i, 384 * K:].tobytes() for i in range(bsz)]),
                 device)
    y = _dev(_cbd_vector(ETA1, r, 0), device)
    e1 = _dev(_cbd_vector(ETA2, r, K), device)
    e2 = _dev(np.stack([_cbd(ETA2, _prf(ETA2, ri, 2 * K)) for ri in r]), device)
    mu = _dev(decompress(1, byte_decode(1, m)), device)
    y_hat = _ntt_rows(y)
    # u = NTT⁻¹(Âᵀ ∘ ŷ) + e1   (Âᵀ: sum over the ROW index of Â)
    u_hat = _matvec_hat(a_hat.transpose(1, 2), y_hat)
    u = (_intt_rows(u_hat).long() + e1) % Q
    # v = NTT⁻¹(t̂ᵀ ∘ ŷ) + e2 + Decompress₁(m)
    v = (_intt_rows(_dot_hat(t_hat, y_hat)).long() + e2 + mu) % Q
    c1 = byte_encode(DU, compress(DU, _host(u))).reshape(bsz, 32 * DU * K)
    c2 = byte_encode(DV, compress(DV, _host(v)))
    return np.concatenate([c1, c2], axis=1)


def _k_pke_decrypt(dk_pke: np.ndarray, ct: np.ndarray, device) -> np.ndarray:
    """Batched K-PKE.Decrypt: dk_pke (b, 1152) u8, ct (b, 1088) u8.
    Returns m (b, 32) u8."""
    bsz = dk_pke.shape[0]
    u = _dev(decompress(DU, byte_decode(
        DU, ct[:, :32 * DU * K].reshape(bsz, K, 32 * DU))), device)
    v = _dev(decompress(DV, byte_decode(DV, ct[:, 32 * DU * K:])), device)
    s_hat = _dev((byte_decode(12, dk_pke.reshape(bsz, K, 384))
                  % Q)[..., _TO_CG], device)
    w_hat = _dot_hat(s_hat, _ntt_rows(u))
    w = (v.long() - _intt_rows(w_hat).long()) % Q
    return byte_encode(1, compress(1, _host(w)))


# ------------------------------------------------------ KEM entry points

def keygen_batch(d: np.ndarray, z: np.ndarray, device=None):
    """Batched ML-KEM.KeyGen from per-item seeds d, z: (b, 32) u8 each.
    Returns (ek (b, 1184) u8, dk (b, 2400) u8)."""
    device = resolve_device(device)
    d = np.asarray(d, dtype=np.uint8)
    z = np.asarray(z, dtype=np.uint8)
    bsz = d.shape[0]
    gs = [_g(d[i].tobytes() + bytes([K])) for i in range(bsz)]
    rhos = [g[0] for g in gs]
    sigmas = [g[1] for g in gs]
    a_hat = _dev(_expand_a(rhos), device)
    s = _cbd_vector(ETA1, sigmas, 0)
    e = _cbd_vector(ETA1, sigmas, K)
    se_hat = _ntt_rows(_dev(np.concatenate([s, e], axis=1), device))  # one launch
    s_hat, e_hat = se_hat[:, :K], se_hat[:, K:]
    t_hat = (_matvec_hat(a_hat, s_hat).long() + e_hat) % Q
    rho_rows = np.stack([np.frombuffer(r, dtype=np.uint8) for r in rhos])
    ek = np.concatenate(
        [byte_encode(12, _host(t_hat)[..., _TO_FIPS]).reshape(bsz, 384 * K),
         rho_rows], axis=1)
    dk_pke = byte_encode(12, _host(s_hat)[..., _TO_FIPS]).reshape(bsz, 384 * K)
    h_rows = np.stack([np.frombuffer(_h(ek[i].tobytes()), dtype=np.uint8)
                       for i in range(bsz)])
    dk = np.concatenate([dk_pke, ek, h_rows, z], axis=1)
    return ek, dk


def encaps_batch(ek: np.ndarray, m: np.ndarray, device=None):
    """Batched ML-KEM.Encaps with per-item message randomness m
    ((b, 32) u8; the derandomized/KAT interface — callers supply fresh
    randomness).  Returns (K (b, 32) u8, ct (b, 1088) u8)."""
    device = resolve_device(device)
    ek = np.asarray(ek, dtype=np.uint8)
    m = np.asarray(m, dtype=np.uint8)
    bsz = ek.shape[0]
    keys, seeds = [], []
    for i in range(bsz):
        k_i, r_i = _g(m[i].tobytes() + _h(ek[i].tobytes()))
        keys.append(np.frombuffer(k_i, dtype=np.uint8))
        seeds.append(r_i)
    ct = _k_pke_encrypt(ek, m, seeds, device)
    return np.stack(keys), ct


def decaps_batch(dk: np.ndarray, ct: np.ndarray, device=None) -> np.ndarray:
    """Batched ML-KEM.Decaps with implicit rejection: dk (b, 2400) u8,
    ct (b, 1088) u8.  Returns the shared keys (b, 32) u8."""
    device = resolve_device(device)
    dk = np.asarray(dk, dtype=np.uint8)
    ct = np.asarray(ct, dtype=np.uint8)
    bsz = dk.shape[0]
    dk_pke = dk[:, :384 * K]
    ek = dk[:, 384 * K:768 * K + 32]
    h = dk[:, 768 * K + 32:768 * K + 64]
    z = dk[:, 768 * K + 64:]
    m2 = _k_pke_decrypt(dk_pke, ct, device)
    keys, rejects, seeds = [], [], []
    for i in range(bsz):
        k_i, r_i = _g(m2[i].tobytes() + h[i].tobytes())
        keys.append(np.frombuffer(k_i, dtype=np.uint8))
        rejects.append(np.frombuffer(
            _j(z[i].tobytes() + ct[i].tobytes()), dtype=np.uint8))
        seeds.append(r_i)
    ct2 = _k_pke_encrypt(ek, m2, seeds, device)
    ok = (ct2 == ct).all(axis=1)
    return np.where(ok[:, None], np.stack(keys), np.stack(rejects))
