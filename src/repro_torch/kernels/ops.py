"""Entry points of the NTT/dyadic/Galois compute layer.

Two families.  The single-prime ops (``ntt``/``intt``/``dyadic_mul``/
``dyadic_mac``) take one prime's ``NTTParams`` and int32 residues of any
leading shape (..., n), and run where the tensor lives: the paper's
NTT-128 unit and its Barrett MM/MA.  The multi-prime banks ops follow.

Every banks function takes a TablePack / FourStepPack dict of int32 tensors
(see ``fhe.batched``) whose per-prime rows are stacked on axis 0 — the
paper's Fig 22 parallel NTT-bank array — and dispatches to a kernel
wrapper, which launches the Hopper kernel for a CUDA tensor and runs the
plain version for a CPU tensor.  ``ntt_banks``/``intt_banks`` take a
``core.ringspec.ring_table_pack`` of int16 tensors unchanged (the
small-ring lane, with ``negacyclic=False``), and
``dyadic_basemul_banks`` is that ring's basecase product.

Ciphertext-batch axis convention: the banks entry points also accept
``batch_leading=True``, meaning the input is a ``(b, k, ..., n)`` stack
of ``b`` polynomials over the same k-prime basis; the leading axis is
swapped behind the prime axis, folded into the kernel batch, and
swapped back on the way out.

Below ``FOURSTEP_MIN_N`` the whole transform is one banks kernel and
NTT rows are in bit-reversed order; at and above it the four-step
pipeline runs (two bank passes of n1- and n2-point transforms with the
step-3 twiddle multiply between them) and NTT rows are in natural order.
On the card each way of the four-step is two kernels
(``csrc/fourstep.cu``) that carry the psi (or psi^-1) weights, the
step-3 twiddle, the transposes and the bit-reversals themselves; in the
reference, and in the port's plain versions on the CPU, those are torch
indexing and weight-row multiplies around the bank transforms.

The key switch's RNS base conversions run per coefficient, on either
NTT layout: ``extend_centered_banks`` (the mod-up onto a basis, one prime
per digit), ``base_conv_banks`` (hybrid key switching's fast base
conversion: the mod-up of digits of several primes, and the mod-down's
conversion of the special primes) and ``mod_down_tail_banks`` (the
mod-down's subtract and P^-1 multiply, with the sum into a ciphertext
half folded in).

The ``keccak_*`` entry points are FIPS 202's sponges over rows of bytes
(uint8 (rows, len) tensors, any row stride) and ML-KEM's two samplers
built on them (``csrc/keccak.cu``): the hashes take the concatenation
a[r] || b[r] (|| ``extra``, one byte) of each row.  ``mlkem_decode_check``
and ``mlkem_encaps_tail`` are ML-KEM's byte codecs around encryption
(``csrc/mlkem_codec.cu``).  ``keccak_expand_mask``,
``keccak_sample_in_ball``, ``keccak_rej_ntt_poly``, ``keccak_rej_bounded``
and ``keccak_mu_rho`` are ML-DSA's samplers and its signing stream's
refill hashes, ``mldsa_*`` its codec around the signing loop
(``csrc/mldsa_codec.cu``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import obs
from repro_torch.kernels import (basis_kernel, codec_kernel, dyadic_kernel, galois_kernel,
                                  keccak_kernel, mldsa_kernel, ntt_kernel)

FOURSTEP_MIN_N = 1 << 13


# ------------------------------------------------------ single prime

def _single_rows(where: str, x, p) -> torch.Tensor:
    """(..., n) -> contiguous (B, n) rows of ring p."""
    if x.ndim == 0 or x.shape[-1] != p.n:
        raise ValueError(f"{where}: rows of {tuple(x.shape)[-1:]} for params "
                         f"of n={p.n}")
    return x.reshape(-1, p.n).contiguous()


def ntt(x, p, *, negacyclic: bool = True, lazy: bool = True):
    """Batched single-prime forward NTT.  x: (..., n) int32 residues in
    [0, p.q) -> (..., n) in bit-reversed order and [0, q), on x's device.
    ``lazy`` selects the deferred-reduction butterflies; the epilogue
    reduces either way, so outputs are bit-identical."""
    out = ntt_kernel.ntt_fwd(_single_rows("ntt", x, p), p,
                             negacyclic=negacyclic, lazy=lazy)
    return out.reshape(x.shape)


def intt(x, p, *, negacyclic: bool = True, lazy: bool = True):
    """Inverse of ``ntt``: bit-reversed (..., n) in, natural order out."""
    out = ntt_kernel.ntt_inv(_single_rows("intt", x, p), p,
                             negacyclic=negacyclic, lazy=lazy)
    return out.reshape(x.shape)


def dyadic_mul(a, b, p, *, lazy: bool = True):
    """a .* b mod p.q for NTT-domain operands of one shape."""
    return dyadic_kernel.dyadic_mul(a.contiguous(), b.contiguous(), q=p.q,
                                    mu=p.barrett_mu, lazy=lazy)


def dyadic_mac(acc, a, b, p, *, lazy: bool = True):
    """acc + a .* b mod p.q (the MM -> MA chain) for operands of one shape."""
    return dyadic_kernel.dyadic_mac(acc.contiguous(), a.contiguous(),
                                    b.contiguous(), q=p.q, mu=p.barrett_mu,
                                    lazy=lazy)


# ------------------------------------------------ multi-prime NTT banks


def _rows(t: dict, k: int, *names):
    """First-k prime rows of the named pack entries (so a pack for a
    superset basis, e.g. basis + special, works on k-row inputs)."""
    return tuple(t[name][:k] for name in names)


def _spanned(fn):
    """Wrap a banks entry point in an ``obs.span("ops.<name>")``.  Inside
    a CUDA-graph capture (``fhe.evalplan``) the span times the capture's
    host work once, not the replays.  Disabled, it is one flag check."""
    name = f"ops.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not obs.enabled():
            return fn(*args, **kw)
        with obs.span(name, cat="kernel"):
            return fn(*args, **kw)
    return wrapper


def _ct_batch_axis(fn):
    """``batch_leading=True`` reads the first argument as a (b, k, ..., n)
    stack: swap the ciphertext axis behind the prime axis, run the
    prime-major path, swap the output back."""
    @functools.wraps(fn)
    def wrapper(x, *args, batch_leading: bool = False, **kw):
        if batch_leading:
            return fn(x.transpose(0, 1), *args, **kw).transpose(0, 1)
        return fn(x, *args, **kw)
    return wrapper


def _as3(x: torch.Tensor) -> torch.Tensor:
    """(k, ..., n) -> contiguous (k, B, n) view for a kernel wrapper."""
    return x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()


@_spanned
@_ct_batch_axis
def ntt_banks(x, t: dict, *, negacyclic: bool = True, lazy: bool = True,
              reduce_out: bool = True):
    """Batched multi-prime forward NTT.  x: (k, ..., n) int32, row i
    reduced mod t['qs'][i]; t: TablePack for (at least) those k primes.
    ``lazy`` keeps butterflies in [0, 2q); ``reduce_out=False`` (lazy
    only) hands the raw [0, 2q) representatives to a lazy-aware
    consumer.  Output in bit-reversed order."""
    k = x.shape[0]
    qs, tw, twp, psi, psip = _rows(t, k, "qs", "tw", "twp", "psi", "psip")
    out = ntt_kernel.ntt_fwd_banks(_as3(x), qs, tw, twp, psi, psip,
                                   negacyclic=negacyclic, lazy=lazy,
                                   reduce_out=reduce_out)
    return out.reshape(x.shape)


@_spanned
@_ct_batch_axis
def intt_banks(x, t: dict, *, negacyclic: bool = True, lazy: bool = True,
               reduce_out: bool = True):
    k = x.shape[0]
    qs, ninv, ninv_p, itw, itwp, ipsin, ipsinp = _rows(
        t, k, "qs", "ninv", "ninv_p", "itw", "itwp", "ipsin", "ipsinp")
    out = ntt_kernel.ntt_inv_banks(_as3(x), qs, ninv, ninv_p, itw, itwp,
                                   ipsin, ipsinp, negacyclic=negacyclic,
                                   lazy=lazy, reduce_out=reduce_out)
    return out.reshape(x.shape)


@_spanned
@_ct_batch_axis
def twiddle_mul_banks(x, w, wp, qs, *, lazy: bool = False):
    """Per-prime weight-row multiply: x (k, ..., n), w/wp (k, n), qs (k,).
    The four-step step-3 twiddle and the negacyclic psi weights.  Any
    input representative; ``lazy`` emits the [0, 2q) one."""
    out = ntt_kernel.twiddle_mul_banks(_as3(x), qs, w, wp, lazy=lazy)
    return out.reshape(x.shape)


@_spanned
@_ct_batch_axis
def galois_banks(x, idx):
    """Galois automorphism in the NTT domain: out[..., j] = x[..., idx[j]].

    x: (k, ..., n) int32 NTT-form residue rows; idx: (n,) int32 slot
    permutation from ``core.params.galois_eval_perm``, the same row for
    every prime.  This replaces the iNTT -> permute -> NTT round trip of
    rotate/conjugate with one gather kernel.

    A (B, n) ``idx`` applies gather row b to batch row b (B must equal the
    product of x's middle dims), so one launch can mix rotation amounts
    across a ciphertext batch; ``batch_leading=True`` reads x as a
    (b, k, ..., n) ciphertext-batch stack as in ``ntt_banks``."""
    if idx.ndim == 2:
        if idx.shape != (math.prod(x.shape[1:-1]), x.shape[-1]):
            raise ValueError(f"galois_banks: per-batch idx {tuple(idx.shape)} "
                             f"for x {tuple(x.shape)}")
        out = galois_kernel.galois_banks_multi(_as3(x), idx.contiguous())
    else:
        out = galois_kernel.galois_banks(_as3(x), idx.contiguous())
    return out.reshape(x.shape)


@_spanned
def galois_digits_banks(ext, idx):
    """Galois gather over key-switch digit extensions — the hoisted-
    rotation move: per-batch gather rows applied to a shared digit
    decomposition instead of re-decomposing per rotation.

    ext: (d, k, B, n) int32 NTT-domain digit extensions (the
    ``fhe.batched.decompose_banks`` layout); idx: (B, n) int32 gather
    rows, row b applied to batch column b of every digit and prime row.
    A (d, k, 1, n) ext against a (B, n) idx with B > 1 runs in shared
    mode: every gather row reads the one digit stack, which is never
    replicated B-fold in device memory.  Returns (d, k, B, n)."""
    d, k, b, n = ext.shape
    bi = idx.shape[0]
    shared = b == 1 and bi != 1
    if idx.shape != (bi, n) or not (shared or bi == b):
        raise ValueError(f"galois_digits_banks: idx {tuple(idx.shape)} for "
                         f"ext {tuple(ext.shape)}")
    return galois_kernel.galois_digits(ext.contiguous(), idx.contiguous(),
                                       shared=shared)


def fourstep_dims(fp: dict) -> tuple[int, int]:
    """(n1, n2) of a four-step pack, read from its table shapes."""
    return fp["pack1"]["tw"].shape[-1] * 2, fp["pack2"]["tw"].shape[-1] * 2


@_spanned
@_ct_batch_axis
def ntt_fourstep_banks(x, fp: dict, *, negacyclic: bool = True,
                       lazy: bool = True):
    """Large-N forward NTT via the four-step decomposition (paper §IX).
    x: (k, ..., n); fp: FourStepPack for at least those k primes.  Output
    in natural frequency order (A_hat[k2*n1 + k1]), in [0, q).  On the
    card two passes of ``csrc/fourstep.cu``, reading x through its strides
    where its middle axes fold into one; on the CPU the reference's chain
    of bank passes (``kernels.ref.fourstep_chain``), whose lazy inter-pass
    values ride in [0, 2q) as the kernels' do."""
    k = x.shape[0]
    n1, n2 = fourstep_dims(fp)
    n = n1 * n2
    if x.shape[-1] != n:
        raise ValueError(f"ntt_fourstep_banks: rows of {x.shape[-1]} for a "
                         f"{n1}x{n2} pack")
    out = ntt_kernel.ntt_fourstep_banks(x.reshape(k, -1, n), fp,
                                        negacyclic=negacyclic, lazy=lazy)
    return out.reshape(x.shape)


@_spanned
@_ct_batch_axis
def intt_fourstep_banks(x, fp: dict, *, negacyclic: bool = True,
                        lazy: bool = True):
    """Inverse of ``ntt_fourstep_banks`` (natural-order input), in [0,
    q).  The two sub-iNTT passes contribute 1/N1 * 1/N2; the final
    multiply (psi^-i, or pass 1's ninv epilogue) fully reduces.  On the
    card two passes of ``csrc/fourstep.cu``, reading x through its strides
    where its middle axes fold into one; on the CPU the reference's chain
    of bank inverses (``kernels.ref.ifourstep_chain``)."""
    k = x.shape[0]
    n1, n2 = fourstep_dims(fp)
    n = n1 * n2
    if x.shape[-1] != n:
        raise ValueError(f"intt_fourstep_banks: rows of {x.shape[-1]} for a "
                         f"{n1}x{n2} pack")
    out = ntt_kernel.intt_fourstep_banks(x.reshape(k, -1, n), fp,
                                         negacyclic=negacyclic, lazy=lazy)
    return out.reshape(x.shape)


@_spanned
def dyadic_inner_banks(ext, evk, t: dict, *, lazy: bool = True, out=None, bits: int = 32):
    """Key-switch inner product out[j] = sum_i ext[i, j] * evk[i, j] mod q_j.
    ext: (d, k, B, n) NTT-domain digit extensions, read in place through
    its strides (``decompose_extend``'s (digit, prime, B, n) transpose is
    not copied); evk: one key, or the pair (evk_b, evk_a) of a key
    switch, each (d, k, n) shared or (d, k, B, n) per-batch key digits; t:
    pack whose rows align with axis 1.  A pair is one launch that reads
    ext once for both, and returns a pair of (k, B, n) stacks; ``out``, in
    the same form, are (k, B, n) views to write instead.  Counts
    ``ops.dyadic_inner.strided`` for each call on a non-contiguous ext,
    the copies it avoids.  ``bits`` is the moduli's Barrett trait (23
    for ML-DSA's q, whose Â ŷ and ĉ products run here with the k rows of
    the matrix or the key in the prime axis)."""
    keys = evk if isinstance(evk, tuple) else (evk,)
    if ext.ndim != 4 or ext.shape[1] != t["qs"].shape[0] or any(
            e.ndim not in (3, 4) for e in keys):
        raise ValueError(f"dyadic_inner_banks: ext {tuple(ext.shape)}, evk "
                         f"{[tuple(e.shape) for e in keys]} for {t['qs'].shape[0]} "
                         "primes")
    for e in keys:
        if e.ndim == 4 and e.shape != ext.shape:
            raise ValueError(f"dyadic_inner_banks: per-batch evk {tuple(e.shape)} "
                             f"!= ext {tuple(ext.shape)}")
    if obs.enabled() and not ext.is_contiguous():
        obs.counter_add("ops.dyadic_inner.strided")
    return dyadic_kernel.dyadic_inner_banks(ext, evk, t["qs"], t["mu"], lazy=lazy,
                                            out=out, bits=bits)


@_spanned
def dyadic_basemul_banks(a, b, t: dict, *, batch_leading: bool = False,
                         lazy: bool = True):
    """Degree-1 basecase multiplication of an INCOMPLETE ring (a
    ``core.ringspec.RingSpec`` with block=2, e.g. ML-KEM): pair j of the
    CG-ordered NTT domain is (x[j], x[j+n/2]) and

        c0[j] = a0·b0 + γ_j·(a1·b1)      c1[j] = a0·b1 + a1·b0

    with the per-pair ζ factors γ from the ring pack's ``gamma`` /
    ``gammap`` rows.  a, b: (k, ..., n) canonical [0, q) int16 NTT-domain
    operands over the pack's rings (or (b, k, ..., n) stacks with
    ``batch_leading=True`` — both operands swap); t: a ring pack on the
    operands' device.  A non-contiguous operand (a broadcast right-hand
    side) is copied to a contiguous one first."""
    if batch_leading:
        return dyadic_basemul_banks(a.transpose(0, 1), b.transpose(0, 1), t,
                                    lazy=lazy).transpose(0, 1)
    if a.shape != b.shape:
        raise ValueError(f"dyadic_basemul_banks: operand shapes {tuple(a.shape)} "
                         f"!= {tuple(b.shape)}")
    k = a.shape[0]
    qs, mus, gamma, gammap = _rows(t, k, "qs", "mu", "gamma", "gammap")
    out = dyadic_kernel.dyadic_basemul_banks(_as3(a), _as3(b), qs, mus, gamma,
                                             gammap, lazy=lazy)
    return out.reshape(a.shape)


@_spanned
def extend_centered_banks(ci, src_qs, dst_qs):
    """Centred base extension (the key switch's mod-up, alpha = 1): digit
    i of ci (d, ..., n), a residue mod src_qs[i], read as a value in
    (-q/2, q/2] and reduced onto each of the kt primes dst_qs.  src_qs
    may hold more than d rows (its first d are read) and need not be
    dst_qs's primes.  Returns (kt, d, ..., n): the prime axis first, so
    the forward banks fold the digit axis into their batch with no copy."""
    d = ci.shape[0]
    out = basis_kernel.extend_centered(_as3(ci), src_qs[:d].contiguous(),
                                       dst_qs.contiguous())
    return out.reshape((dst_qs.shape[0],) + tuple(ci.shape))


@_spanned
def base_conv_banks(x, conv: dict):
    """Fast base conversion (hybrid key switching's mod-up, alpha > 1,
    and its mod-down's conversion of the K special primes): x (R, ...,
    n) coefficient residue rows, canonical in [0, q); conv a conversion
    table (``fhe.batched.conv_table``) whose group g reads x's rows
    src[g, :cnt[g]] and writes Conv_g(x) onto each of its kt targets.
    Returns (kt, groups, ..., n): the prime axis first, as
    ``extend_centered_banks``'s."""
    out = basis_kernel.base_conv(_as3(x), conv)
    return out.reshape((conv["dst"].shape[0], conv["src"].shape[0]) + tuple(x.shape[1:]))


@_spanned
def mod_down_tail_banks(acc, extn, t: dict, *, addend=None,
                        batch_leading: bool = False):
    """The end of the RNS floor by t's last prime P: (acc - extn) * P^-1
    mod q_j for the k = extn.shape[0] first primes of t.  acc: (k', B, n)
    with k' >= k (its first k rows are read, through any strides of its
    first two axes); extn: (k, B, n), the extension of acc's P row in NTT
    form.  Returns (k, B, n), or (B, k, n) with ``batch_leading``.
    ``addend`` (in the output's layout, over the first Ba <= B batch
    columns, any strides) is added mod q_j, as a key switch's c0 half."""
    k = extn.shape[0]
    return basis_kernel.mod_down_tail(acc[:k], extn.contiguous(), t["qs"][:k],
                                      t["pinv"], t["pinv_p"], addend,
                                      batch_leading=batch_leading)


# ------------------------------------------------------------ Keccak

@_spanned
def keccak_sha3_256(a, b=None):
    """SHA3-256 of each row a[r] || b[r]: (rows, 32) uint8 (ML-KEM's H)."""
    return keccak_kernel.keccak_hash(a, b, rate=136, suffix=0x06, out_len=32)


@_spanned
def keccak_sha3_512(a, b=None, *, extra=None):
    """SHA3-512 of each row a[r] || b[r] || extra: (rows, 64) uint8
    (ML-KEM's G)."""
    return keccak_kernel.keccak_hash(a, b, extra=extra, rate=72, suffix=0x06, out_len=64)


@_spanned
def keccak_shake256(a, b=None, *, out_len: int):
    """SHAKE256 of each row a[r] || b[r], ``out_len`` bytes a row
    (ML-KEM's J at 32)."""
    return keccak_kernel.keccak_hash(a, b, rate=136, suffix=0x1F, out_len=out_len)


@_spanned
def keccak_sample_ntt(rho, *, transpose: bool = False):
    """ML-KEM's matrix from rho (b, 32) uint8: SampleNTT(rho || j || i)
    (FIPS 203 Alg. 7, SHAKE128 with rejection below q) in the CG order of
    ``MLKEM_RING``'s NTT domain, (b, 3, 3, 256) int16 at [r, i, j], or the
    transpose at [r, j, i]."""
    return keccak_kernel.sample_ntt(rho, transpose=transpose)


@_spanned
def keccak_prf_cbd(seed, *, n0: int, count: int):
    """CBD_2(PRF_2(seed[r], n0 + c)) (FIPS 203 Alg. 8 over SHAKE256) for c <
    count: (b, count, 256) int16 in [0, q), natural coefficient order."""
    return keccak_kernel.prf_cbd(seed, n0=n0, count=count)


# -------------------------------------------------------- ML-KEM codec

@_spanned
def mlkem_decode_check(ek):
    """ByteDecode12 of each row's first 1152 bytes (an encapsulation key's
    t̂, a decapsulation key's ŝ) in ``MLKEM_RING``'s CG order, mod q, and
    FIPS 203 §7.2's modulus check: (t_hat (b, 3, 256) int16, ok (b,) bool)."""
    return codec_kernel.decode_check(ek)


@_spanned
def mlkem_encaps_tail(u, v, e, m, kr=None, ok=None):
    """The end of ML-KEM-768's encryption: ct = ByteEncode10(Compress10(u +
    e1)) || ByteEncode4(Compress4(v + e2 + Decompress1(m))), (b, 1088)
    uint8, and with kr, K = kr[:, :32]; rows where ok is False zeroed.
    Returns (K or None, ct)."""
    return codec_kernel.encaps_tail(u, v, e, m, kr, ok)


# ------------------------------------------------------------ ML-DSA

@_spanned
def keccak_expand_mask(rho, kappa):
    """FIPS 204 ExpandMask(rho[s], kappa[s]) of rho (S, 64) uint8 and kappa
    (S,) int32: (S, 5, 256) int32 residues mod q."""
    return keccak_kernel.expand_mask(rho, kappa)


@_spanned
def keccak_sample_in_ball(ct):
    """FIPS 204 SampleInBall of ct (S, 48) uint8: (S, 256) int32 in {0, 1,
    q - 1}."""
    return keccak_kernel.sample_in_ball(ct)


@_spanned
def keccak_rej_ntt_poly(rho):
    """FIPS 204 ExpandA of rho (b, 32) uint8: (b, 6, 5, 256) int32 in the
    NTT order of ``MLDSA_RING`` (FIPS 204's own)."""
    return keccak_kernel.rej_ntt_poly(rho)


@_spanned
def keccak_rej_bounded(rho, *, n0: int, count: int):
    """FIPS 204 RejBoundedPoly(rho[r] || n0 + c), eta = 4, for c < count:
    (b, count, 256) int32 residues mod q."""
    return keccak_kernel.rej_bounded(rho, n0=n0, count=count)


@_spanned
def keccak_mu_rho(tr, key, msg, rnd, slots, reqs, count, mu_out, rho_out):
    """The signing stream's refill hashes, mu = H(tr || M') and rho'' =
    H(key || rnd || mu), of the first ``count`` queued requests, into
    their slots' rows (``keccak_kernel.mu_rho``)."""
    return keccak_kernel.mu_rho(tr, key, msg, rnd, slots, reqs, count, mu_out, rho_out)


@_spanned
def mldsa_w1_encode(w):
    """w1Encode(HighBits(w)) of w (k, S, 256) int32: (S, 768) uint8."""
    return mldsa_kernel.w1_encode(w)


@_spanned
def mldsa_check(y, w, cs, active):
    """Sign_internal's bounds of every slot: (S,) bool
    (``mldsa_kernel.sign_check``)."""
    return mldsa_kernel.sign_check(y, w, cs, active)


@_spanned
def mldsa_emit(ct, y, w, cs, dest, ids, kappa, ring, ring_ids, ring_iters):
    """sigEncode of the accepted slots into the output ring, in place
    (``mldsa_kernel.sign_emit``)."""
    return mldsa_kernel.sign_emit(ct, y, w, cs, dest, ids, kappa, ring, ring_ids,
                                  ring_iters)
