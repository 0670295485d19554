"""Batched ML-KEM-768 (FIPS 203) on the card, from input bytes to output
bytes.

The second scheme of the port.  Every step of an entry point runs on its
device as tensor work over the whole batch, with no loop over rows and
nothing read back until the caller reads a result:

  hashing  H, G, J, SampleNTT and PRF fused with CBD on Keccak-f[1600]
           (``ops.keccak_*``; ``csrc/keccak.cu`` on the card)
  ring     the incomplete n = 256 / q = 3329 transforms
           (``ops.ntt_banks`` / ``ops.intt_banks`` on the int16 lane:
           ``ntt_fwd_banks_u16`` / ``ntt_inv_banks_u16`` on the card) and
           the degree-1 basecase products (``ops.dyadic_basemul_banks``)
           under the ``core.ringspec.MLKEM_RING`` descriptor: the SAME
           kernel entry points the CKKS stack uses
  codec    the key's ByteDecode12 with the §7.2 check and the
           ciphertext's Compress and ByteEncode (``ops.mlkem_decode_check``,
           ``ops.mlkem_encaps_tail``; ``csrc/mlkem_codec.cu`` on the card);
           key generation's and decryption's codecs as tensor ops
           (``pq.codec``)

Inputs and outputs: uint8 tensors (b, bytes), the results on the inputs'
device.  Numpy arrays are taken too (the serving engine's and the
tests'): they move to ``device`` (None: the card; ``"cpu"`` runs the same
code on the kernels' plain versions and gives the same bytes) and the
results come back as numpy arrays.

Batching: every public entry point is batched over a leading ``(b,)``
axis of independent requests, and all the rows of a step fold into one
launch: a b = 64 keygen runs its 384 CBD polynomials through one
forward-NTT launch and its 576 matrix products through one basemul
launch, and its 576 SampleNTT streams through one Keccak launch.

Orders and domains: coefficient-domain polynomials are natural order.
The CG-network NTT emits the 128 degree-1 residues in CG pair order —
pair j lives at (x[j], x[j+128]) with per-pair factor γ_j — while FIPS
203 interleaves them as adjacent pairs: ``fips[2*b + p] = cg[(p << 7) |
b]``.  ByteDecode12 takes FIPS pair b from byte triple b, so the CG
order is its first 12-bit fields followed by its second ones (and
ByteEncode12 the reverse), and SampleNTT stores CG order itself: the
serialized keys and ciphertexts are bit-exact FIPS 203 while the
NTT-domain arithmetic stays in CG order.

The encapsulation key check (FIPS 203 §7.2): ``encaps_batch`` checks
every row's key, ByteEncode12(ByteDecode12(ek)) == ek, which holds
exactly when every 12-bit coefficient of ek lies below q.  It returns
the verdict a row, and a row that fails has zero K and ct.

Observability: spans ``mlkem.keygen`` / ``mlkem.encaps`` /
``mlkem.decaps`` (with ``b``) around an entry point, and inside them
``mlkem.hash``, ``mlkem.sample``, ``mlkem.ring`` and ``mlkem.codec``
around the launches of each kind (host time: nothing waits for the
card); counters ``mlkem.rows.<op>`` and ``mlkem.keccak_perms``, the
permutations launched at SampleNTT's least three blocks a stream (44 a
row for encaps), counted from the shapes on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import from_reference, resolve_device
from repro_torch.core.ringspec import MLKEM_RING, ring_table_pack
from repro_torch.kernels import ops
from repro_torch.kernels.keccak_kernel import SAMPLE_BLOCKS, sponge_perms
from repro_torch.pq.codec import byte_decode, byte_encode, compress, decompress, encode12

K = 3                       # ML-KEM-768 module rank (eta1 = eta2 = 2: the CBD kernel's)
DU = 10
DV = 4
N = MLKEM_RING.n            # 256
Q = MLKEM_RING.q            # 3329

PKE_BYTES = 384 * K         # 1152: K encoded NTT-domain polynomials
EK_BYTES = PKE_BYTES + 32   # 1184
DK_BYTES = 768 * K + 96     # 2400
CT_BYTES = 32 * (DU * K + DV)   # 1088
U_BYTES = 32 * DU * K       # 960

# Keccak permutations a row an entry point launches (SampleNTT's 9
# streams at their least three blocks each)
_SAMPLE_PERMS = K * K * SAMPLE_BLOCKS
PERMS = {
    # G(d || k), SampleNTT, PRF for s and e, H(ek)
    "keygen": sponge_perms(33, 72, 64) + _SAMPLE_PERMS + 2 * K
              + sponge_perms(EK_BYTES, 136, 32),
    # H(ek), G(m || h), SampleNTT, PRF for y, e1 and e2
    "encaps": sponge_perms(EK_BYTES, 136, 32) + sponge_perms(64, 72, 64)
              + _SAMPLE_PERMS + 2 * K + 1,
    # G(m' || h), J(z || c), then encryption's SampleNTT and PRF
    "decaps": sponge_perms(64, 72, 64) + sponge_perms(32 + CT_BYTES, 136, 32)
              + _SAMPLE_PERMS + 2 * K + 1,
}


# ------------------------------------------------------- inputs, outputs

def _bytes_in(x, width: int, name: str, device) -> torch.Tensor:
    """(b, width) uint8 rows on ``device``: a tensor as it is, an array
    moved there."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)
    if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"ML-KEM: {name} must be (b, {width}) uint8, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"ML-KEM: {name} is on {x.device}, expected {device}")
    return x


def _inputs(first, device):
    """The entry point's device (a tensor's own, else ``device`` resolved)
    and whether results go back to the host as numpy."""
    if isinstance(first, torch.Tensor):
        if device is not None and torch.device(device) != first.device:
            raise ValueError(f"ML-KEM: inputs on {first.device}, device={device}")
        return first.device, False
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, True


def _out(host: bool, *ts):
    return tuple(t.cpu().numpy() for t in ts) if host else ts


def _count(op: str, b: int) -> None:
    if obs.enabled():
        obs.counter_add(f"mlkem.rows.{op}", b)
        obs.counter_add("mlkem.keccak_perms", b * PERMS[op])


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
    right-hand side to a contiguous stack first); the K = 3 term sums
    stay int16 (3 (q - 1) < 2^15) and reduce mod q once."""
    bsz = a_hat.shape[0]
    rhs = y_hat[:, None].expand(bsz, K, K, N)
    p = _basemul_rows(a_hat, rhs)
    return (p[:, :, 0] + p[:, :, 1] + p[:, :, 2]) % Q


def _dot_hat(t_hat: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """(t̂ᵀ ∘ ŷ) = Σ_j t̂[j] ⊛ ŷ[j]: (b, K, 256) x (b, K, 256) ->
    (b, 256), one basemul launch + device sum."""
    p = _basemul_rows(t_hat, y_hat)
    return (p[:, 0] + p[:, 1] + p[:, 2]) % Q


# --------------------------------------------------------- K-PKE layers

def _k_pke_encrypt(ek: torch.Tensor, m: torch.Tensor, kr: torch.Tensor, *, kem: bool):
    """Batched K-PKE.Encrypt: ek (b, 1184), m (b, 32) messages and kr (b,
    64), G's output, whose second half is the randomness r; uint8 rows
    (views of wider rows too).  With ``kem``, also Encaps's K = kr[:, :32]
    and FIPS 203 §7.2's check, every row whose key fails it zeroed.
    Returns (K or None, ct (b, 1088) uint8, ok (b,) bool)."""
    bsz = ek.shape[0]
    r = kr[:, 32:]
    with obs.span("mlkem.sample", b=bsz):
        a_t = ops.keccak_sample_ntt(ek[:, PKE_BYTES:], transpose=True)     # Âᵀ
        y = ops.keccak_prf_cbd(r, n0=0, count=K)
        e = ops.keccak_prf_cbd(r, n0=K, count=K + 1)                       # e1, e2
    with obs.span("mlkem.codec", b=bsz):
        t_hat, ok = ops.mlkem_decode_check(ek)
    with obs.span("mlkem.ring", b=bsz):
        y_hat = _ntt_rows(y)
        # u = NTT⁻¹(Âᵀ ∘ ŷ) + e1,  v = NTT⁻¹(t̂ᵀ ∘ ŷ) + e2 + Decompress₁(m)
        u = _intt_rows(_matvec_hat(a_t, y_hat))
        v = _intt_rows(_dot_hat(t_hat, y_hat))
    with obs.span("mlkem.codec", b=bsz):
        key, ct = ops.mlkem_encaps_tail(u, v, e, m, kr if kem else None, ok if kem else None)
    return key, ct, ok


def _k_pke_decrypt(dk_pke: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Batched K-PKE.Decrypt: dk_pke (b, >= 1152) rows starting with ŝ, ct
    (b, 1088) uint8 rows.  Returns m (b, 32) uint8."""
    bsz = ct.shape[0]
    with obs.span("mlkem.codec", b=bsz):
        u = decompress(DU, byte_decode(DU, ct[:, :U_BYTES].unflatten(-1, (K, 32 * DU))))
        v = decompress(DV, byte_decode(DV, ct[:, U_BYTES:]))
        s_hat, _ = ops.mlkem_decode_check(dk_pke)
    with obs.span("mlkem.ring", b=bsz):
        w = _intt_rows(_dot_hat(s_hat, _ntt_rows(u.to(torch.int16))))
    with obs.span("mlkem.codec", b=bsz):
        return byte_encode(1, compress(1, (v - w.int()) % Q))


# ------------------------------------------------------ KEM entry points

def keygen_batch(d, z, device=None):
    """Batched ML-KEM.KeyGen from per-item seeds d, z: (b, 32) uint8
    each.  Returns (ek (b, 1184), dk (b, 2400)) uint8."""
    device, host = _inputs(d, device)
    d = _bytes_in(d, 32, "d", device)
    z = _bytes_in(z, 32, "z", device)
    bsz = d.shape[0]
    with obs.span("mlkem.keygen", b=bsz):
        with obs.span("mlkem.hash", b=bsz):
            g = ops.keccak_sha3_512(d, extra=K)          # (rho, sigma) = G(d || k)
        rho, sigma = g[:, :32], g[:, 32:]
        with obs.span("mlkem.sample", b=bsz):
            a_hat = ops.keccak_sample_ntt(rho)
            se = ops.keccak_prf_cbd(sigma, n0=0, count=2 * K)     # s, e
        with obs.span("mlkem.ring", b=bsz):
            se_hat = _ntt_rows(se)                                # one launch
            s_hat, e_hat = se_hat[:, :K], se_hat[:, K:]
            t_hat = (_matvec_hat(a_hat, s_hat) + e_hat) % Q
        with obs.span("mlkem.codec", b=bsz):
            ek = torch.cat([encode12(t_hat).flatten(1), rho], 1)
            dk_pke = encode12(s_hat).flatten(1)
        with obs.span("mlkem.hash", b=bsz):
            h = ops.keccak_sha3_256(ek)
        dk = torch.cat([dk_pke, ek, h, z], 1)
    _count("keygen", bsz)
    return _out(host, ek, dk)


def encaps_batch(ek, m, device=None):
    """Batched ML-KEM.Encaps with per-item message randomness m ((b, 32)
    uint8; the derandomized/KAT interface — callers supply fresh
    randomness) and the encapsulation key check of FIPS 203 §7.2.
    Returns (K (b, 32) uint8, ct (b, 1088) uint8, ok (b,) bool); a row
    whose ek fails the check has ok False and zero K and ct."""
    device, host = _inputs(ek, device)
    ek = _bytes_in(ek, EK_BYTES, "ek", device)
    m = _bytes_in(m, 32, "m", device)
    bsz = ek.shape[0]
    with obs.span("mlkem.encaps", b=bsz):
        with obs.span("mlkem.hash", b=bsz):
            kr = ops.keccak_sha3_512(m, ops.keccak_sha3_256(ek))   # (K, r) = G(m || H(ek))
        key, ct, ok = _k_pke_encrypt(ek, m, kr, kem=True)
    _count("encaps", bsz)
    return _out(host, key, ct, ok)


def decaps_batch(dk, ct, device=None):
    """Batched ML-KEM.Decaps with implicit rejection: dk (b, 2400), ct (b,
    1088) uint8.  Returns the shared keys (b, 32) uint8."""
    device, host = _inputs(dk, device)
    dk = _bytes_in(dk, DK_BYTES, "dk", device)
    ct = _bytes_in(ct, CT_BYTES, "ct", device)
    bsz = dk.shape[0]
    ek = dk[:, PKE_BYTES:PKE_BYTES + EK_BYTES]
    h = dk[:, PKE_BYTES + EK_BYTES:PKE_BYTES + EK_BYTES + 32]
    z = dk[:, PKE_BYTES + EK_BYTES + 32:]
    with obs.span("mlkem.decaps", b=bsz):
        m2 = _k_pke_decrypt(dk, ct)
        with obs.span("mlkem.hash", b=bsz):
            kr = ops.keccak_sha3_512(m2, h)                # (K', r') = G(m' || h)
            rejected = ops.keccak_shake256(z, ct, out_len=32)      # J(z || c)
        _, ct2, _ = _k_pke_encrypt(ek, m2, kr, kem=False)
        with obs.span("mlkem.codec", b=bsz):
            same = (ct2 == ct).all(1, keepdim=True)
            key = torch.where(same, kr[:, :32], rejected)
    _count("decaps", bsz)
    return _out(host, key)[0]
