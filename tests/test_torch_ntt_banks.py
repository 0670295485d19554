"""The port's NTT-bank entry points against the JAX reference on the CPU
(the reference's plain path, ``use_pallas=False``): the single-kernel
forward/inverse transforms at 2^10, the weight-row multiply, and the
four-step pipeline at 2^10 and 2^12.  Integer outputs must be
bit-identical, including the raw [0, 2q) representatives that
``reduce_out=False`` hands to a lazy consumer."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fhe import batched as RB
from repro.fhe import rns as RR
from repro.kernels import ops as RO

from repro_torch import kernels as K
from repro_torch.convert import (from_reference, tensor_to_u16, tensor_to_u32,
                                 u16_to_tensor, u32_to_tensor)
from repro_torch.kernels import ops as TO

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

N = 1 << 10
PRIMES = tuple(RR.make_primes(N, 4))
REF_PACK = RB.build_table_pack(list(PRIMES), N)
PORT_PACK = from_reference(REF_PACK, "cpu")


def _residues(seed, primes, mid, n, band=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, band * q, size=mid + (n,), dtype=np.uint32)
                     for q in primes])


def _same(ref_out, port_out):
    return np.array_equal(np.asarray(ref_out), tensor_to_u32(port_out))


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("reduce_out", [False, True])
@pytest.mark.parametrize("negacyclic", [False, True])
def test_ntt_banks_fwd_inv_match_reference(k, lazy, reduce_out, negacyclic):
    x = _residues(k, PRIMES[:k], (3,), N)
    kw = dict(negacyclic=negacyclic, lazy=lazy, reduce_out=reduce_out)
    r = RO.ntt_banks(jnp.asarray(x), REF_PACK, use_pallas=False, **kw)
    p = TO.ntt_banks(u32_to_tensor(x, "cpu"), PORT_PACK, **kw)
    assert _same(r, p)
    if lazy and not reduce_out:      # the raw band reaches past q somewhere
        assert tensor_to_u32(p).max() >= min(PRIMES[:k])
    # the inverse also takes the [0, 2q) band as its input
    xin = _residues(k + 10, PRIMES[:k], (3,), N, band=2 if lazy else 1)
    r2 = RO.intt_banks(jnp.asarray(xin), REF_PACK, use_pallas=False, **kw)
    p2 = TO.intt_banks(u32_to_tensor(xin, "cpu"), PORT_PACK, **kw)
    assert _same(r2, p2)


def test_ntt_banks_roundtrip_and_counts():
    x = _residues(7, PRIMES, (2,), N)
    K.reset_counts()
    xt = u32_to_tensor(x, "cpu")
    back = TO.intt_banks(TO.ntt_banks(xt, PORT_PACK), PORT_PACK)
    assert torch.equal(back, xt)
    c = K.snapshot()
    assert c["ntt_fwd_banks"] == {"launches": 0, "plain_calls": 1}
    assert c["ntt_inv_banks"] == {"launches": 0, "plain_calls": 1}


@pytest.mark.parametrize("mid", [(1,), (5,), (2, 3)])
def test_ntt_banks_ragged_and_multi_dim_batches(mid):
    x = _residues(11, PRIMES, mid, N)
    r = RO.ntt_banks(jnp.asarray(x), REF_PACK, use_pallas=False)
    p = TO.ntt_banks(u32_to_tensor(x, "cpu"), PORT_PACK)
    assert p.shape == x.shape and _same(r, p)


def test_ntt_banks_batch_leading():
    x = _residues(12, PRIMES, (3,), N).swapaxes(0, 1).copy()    # (b, k, n)
    for fn_r, fn_p in ((RO.ntt_banks, TO.ntt_banks), (RO.intt_banks, TO.intt_banks)):
        r = fn_r(jnp.asarray(x), REF_PACK, use_pallas=False, batch_leading=True)
        p = fn_p(u32_to_tensor(x, "cpu"), PORT_PACK, batch_leading=True)
        assert p.shape == x.shape and _same(r, p)


@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_mul_banks_match_reference(lazy):
    x = _residues(13, PRIMES, (4,), N, band=2)
    qs, w, wp = REF_PACK["qs"], REF_PACK["psi"], REF_PACK["psip"]
    r = RO.twiddle_mul_banks(jnp.asarray(x), w, wp, qs, lazy=lazy, use_pallas=False)
    p = TO.twiddle_mul_banks(u32_to_tensor(x, "cpu"), PORT_PACK["psi"],
                             PORT_PACK["psip"], PORT_PACK["qs"], lazy=lazy)
    assert _same(r, p)


_FS = {}


def _fourstep(n):
    if n not in _FS:
        primes = RR.make_primes(n, 3)
        ref = RB.build_fourstep_pack(primes, n)
        _FS[n] = (primes, ref, from_reference(ref, "cpu"))
    return _FS[n]


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("negacyclic", [False, True])
def test_fourstep_fwd_inv_match_reference(n, lazy, negacyclic):
    primes, ref, port = _fourstep(n)
    x = _residues(n + lazy, primes, (2,), n)
    kw = dict(negacyclic=negacyclic, lazy=lazy)
    r = RO.ntt_fourstep_banks(jnp.asarray(x), ref, use_pallas=False, **kw)
    p = TO.ntt_fourstep_banks(u32_to_tensor(x, "cpu"), port, **kw)
    assert _same(r, p)
    r2 = RO.intt_fourstep_banks(r, ref, use_pallas=False, **kw)
    p2 = TO.intt_fourstep_banks(p, port, **kw)
    assert _same(r2, p2)
    assert np.array_equal(tensor_to_u32(p2), x)


def test_fourstep_batch_leading():
    primes, ref, port = _fourstep(1 << 10)
    x = _residues(21, primes, (3,), 1 << 10).swapaxes(0, 1).copy()
    r = RO.ntt_fourstep_banks(jnp.asarray(x), ref, use_pallas=False,
                              batch_leading=True)
    p = TO.ntt_fourstep_banks(u32_to_tensor(x, "cpu"), port, batch_leading=True)
    assert _same(r, p)


N_BIG = 1 << 13
_BIG = {}


def _big_packs():
    """Table packs for 2 primes at n = 8192, where the card runs one row
    per block (the one-kernel transforms, not the four-step pipeline)."""
    if not _BIG:
        primes = RR.make_primes(N_BIG, 2)
        ref = RB.build_table_pack(list(primes), N_BIG)
        _BIG.update(primes=primes, ref=ref, port=from_reference(ref, "cpu"))
    return _BIG["primes"], _BIG["ref"], _BIG["port"]


@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_banks_at_8192_match_reference(lazy):
    """ops.ntt_banks / intt_banks at n = 8192, (k, B) = (2, 2): every word
    equal to the reference's, lazy and eager."""
    primes, ref, port = _big_packs()
    x = _residues(N_BIG + lazy, primes, (2,), N_BIG)
    r = RO.ntt_banks(jnp.asarray(x), ref, use_pallas=False, lazy=lazy)
    p = TO.ntt_banks(u32_to_tensor(x, "cpu"), port, lazy=lazy)
    assert _same(r, p)
    xin = _residues(N_BIG + 2 + lazy, primes, (2,), N_BIG, band=2 if lazy else 1)
    r2 = RO.intt_banks(jnp.asarray(xin), ref, use_pallas=False, lazy=lazy)
    p2 = TO.intt_banks(u32_to_tensor(xin, "cpu"), port, lazy=lazy)
    assert _same(r2, p2)


@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_mul_banks_any_u32_representative_matches_reference(lazy):
    """The weight-row multiply takes any u32 x (Shoup's contract), the
    words of 2^31 and above included: they travel as negative int32 bit
    patterns in the port and must give the reference's words."""
    rng = np.random.default_rng(14 + lazy)
    x = rng.integers(0, 1 << 32, (len(PRIMES), 3, N), dtype=np.uint64).astype(np.uint32)
    x[:, 0, :4] = [0, 1, (1 << 32) - 1, 1 << 31]
    qs, w, wp = REF_PACK["qs"], REF_PACK["psi"], REF_PACK["psip"]
    r = RO.twiddle_mul_banks(jnp.asarray(x), w, wp, qs, lazy=lazy, use_pallas=False)
    p = TO.twiddle_mul_banks(u32_to_tensor(x, "cpu"), PORT_PACK["psi"],
                             PORT_PACK["psip"], PORT_PACK["qs"], lazy=lazy)
    assert _same(r, p)


# --------------------------------------------------------------------------
# A numpy emulation of the card's schedules (csrc/ntt_regs.cuh), with the
# same index formulas: which thread and register hold which original index
# in each phase, the pairing bit of each stage, the twiddle column as a
# per-thread base plus a per-register constant, the swizzled shared-memory
# exchange between phases, the output positions, and the two-pass split
# of rings above 4096 words.  Arithmetic is the reference's op sequence on
# u32 words (the band reduce written min(s, s - m) as the kernels do).

M32 = 0xFFFFFFFF


def rotl(v, t, L):
    return ((v << t) | (v >> (L - t))) & ((1 << L) - 1)


def rotr(v, t, L):
    return rotl(v, L - t, L)


def reg_bits(LL):
    return min(LL, 4)


def n_phases(LL, rb):
    return -(-LL // rb)


def group(fwd, k, LL, rb):
    return max(LL - rb * (k + 1), 0) if fwd else min(rb * k, LL - rb)


def deposit(i, g, rb):
    return (i & ((1 << g) - 1)) | ((i >> g) << (g + rb))


def swz(l):
    return l ^ ((l >> 4) & 31)


def row_stride(LL):
    return (1 << LL) + (1 << LL) // 16


class _Lane:
    """The kernels' butterflies on uint64 arrays holding u32 lane words."""

    def __init__(self, q, bits, lazy):
        self.q, self.bits, self.lazy = np.uint64(q), bits, lazy
        self.m = self.q * np.uint64(2) if lazy else self.q

    @staticmethod
    def band(s, m):
        s = s & np.uint64(M32)
        return np.minimum(s, (s - m) & np.uint64(M32))

    def shoup_lazy(self, x, w, wp):
        hi = (x * wp) >> np.uint64(self.bits)
        return (x * w - hi * self.q) & np.uint64(M32)

    def mul(self, x, w, wp):
        r = self.shoup_lazy(x, w, wp)
        return r if self.lazy else self.band(r, self.q)

    def add(self, a, b):
        return self.band(a + b, self.m)

    def sub(self, a, b):
        return np.where(a >= b, a - b, (a + (self.m - b)) & np.uint64(M32))

    def fwd(self, lo, hi, w, wp):
        t = self.mul(hi, w, wp)
        return self.add(lo, t), self.sub(lo, t)

    def inv(self, e, o, w, wp):
        return self.add(e, o), self.mul(self.sub(e, o), w, wp)


def _emulate_rows(X, ln, tb, fwd, LL, GL, pre, final, rb):
    """The row body on X (rows, 2^LL) of one prime with 2^rb words a
    thread: rows are whole rings (LL == GL) or consecutive 2^LL-word
    chunks of 2^GL-word rings."""
    NL, H = 1 << LL, 1 << (GL - 1)
    R, TPR = 1 << rb, 1 << (LL - rb)
    rows = X.shape[0]
    stages = tb["tw"].shape[0]
    i = np.arange(TPR, dtype=np.int64)[None, :, None]             # row thread
    r = np.arange(R, dtype=np.int64)[None, None, :]               # register
    ohigh = ((np.arange(rows) & ((1 << (GL - LL)) - 1)) << LL)[:, None, None]
    layout = lambda k: deposit(i, group(fwd, k, LL, rb), rb) | (r << group(fwd, k, LL, rb))
    l0 = layout(0)
    assert sorted(l0.ravel()) == list(range(NL))                  # one owner a word
    v = X[np.arange(rows)[:, None, None], l0]
    if pre and tb["negacyclic"]:
        v = ln.mul(v, tb["w"][l0], tb["wp"][l0])
    smem = np.zeros((rows, row_stride(LL)), dtype=np.uint64)
    for k in range(n_phases(LL, rb)):
        g = group(fwd, k, LL, rb)
        if k:                                                     # the exchange
            g1 = group(fwd, k - 1, LL, rb)
            s1 = swz(deposit(i, g1, rb)) ^ swz(r << g1)
            s2 = swz(deposit(i, g, rb)) ^ swz(r << g)
            assert len(np.unique(s1)) == NL and s1.max() < row_stride(LL)
            smem[:] = 0
            smem[np.arange(rows)[:, None, None], np.broadcast_to(s1, v.shape)] = v
            v = smem[np.arange(rows)[:, None, None], np.broadcast_to(s2, v.shape)]
        obase = ohigh | deposit(i, g, rb)                         # the thread's own bits
        bits = (range(LL - rb * k - 1, g - 1, -1) if fwd
                else range(rb * k, min(rb * (k + 1), LL)))
        for b in bits:
            if (GL - 1 - b if fwd else b) >= stages:
                continue
            lo_r = np.array([x for x in range(R) if not x >> (b - g) & 1])
            hi_r = lo_r | (1 << (b - g))
            if fwd:                                               # stage t pairs bit GL-1-t
                t = GL - 1 - b
                base = rotl(obase, t, GL) & (H - 1)
                C = rotl(lo_r << g, t, GL) & (H - 1)
                row_w, row_wp = tb["tw"][t], tb["twp"][t]
            else:                                                 # applied stage b pairs bit b
                base = rotr(obase, b + 1, GL) & (H - 1)
                C = rotr(lo_r << g, b + 1, GL) & (H - 1)
                row_w, row_wp = tb["tw"][stages - 1 - b], tb["twp"][stages - 1 - b]
            assert not np.any(base & C)                           # base + C == base | C
            j = base + C
            a, c = (ln.fwd if fwd else ln.inv)(v[..., lo_r], v[..., hi_r],
                                               row_w[j], row_wp[j])
            v[..., lo_r], v[..., hi_r] = a, c
    o = ohigh | layout(n_phases(LL, rb) - 1)
    pos = o
    if final and stages != GL:
        pos = rotl(o, stages, GL) if fwd else rotr(o, stages, GL)
    if final:
        v = _final(v, ln, tb, fwd, pos)
    if final and stages != GL and GL == LL and n_phases(LL, rb) > 1:
        # an incomplete ring leaves through the shared row: written at its
        # output positions, read back as runs of 2^rb consecutive words
        rr = np.arange(rows)[:, None, None]
        smem[:] = 0
        smem[rr, swz(pos)] = v
        pos = np.broadcast_to((i << rb) | r, v.shape)
        v = smem[rr, swz(pos)]
    out = np.zeros((rows // (1 << (GL - LL)), 1 << GL), dtype=np.uint64)
    ring = (np.arange(rows) >> (GL - LL))[:, None, None]
    out[ring, pos] = v
    return out.reshape(X.shape)


def _final(v, ln, tb, fwd, pos):
    if fwd:
        return ln.band(v, ln.q) if (ln.lazy and tb["reduce_out"]) else v
    w, wp = (tb["w"][pos], tb["wp"][pos]) if tb["negacyclic"] else (tb["ninv"], tb["ninv_p"])
    r = ln.shoup_lazy(v, np.uint64(w) if np.isscalar(w) else w,
                      np.uint64(wp) if np.isscalar(wp) else wp)
    return r if (ln.lazy and not tb["reduce_out"]) else ln.band(r, ln.q)


def _emulate_cols(X, ln, tb, fwd, S, GL):
    """The column body on X (rings, 2^GL) of one prime: thread c owns the
    2^S words a * 2^(GL-S) + c of its ring."""
    MB, H, R = GL - S, 1 << (GL - 1), 1 << S
    stages = tb["tw"].shape[0]
    c = np.arange(1 << MB, dtype=np.int64)[None, :, None]
    a = np.arange(R, dtype=np.int64)[None, None, :]
    o = (a << MB) + c
    v = X[np.arange(X.shape[0])[:, None, None], o]
    if fwd and tb["negacyclic"]:
        v = ln.mul(v, tb["w"][o], tb["wp"][o])
    for s in range(S):
        ab = S - 1 - s if fwd else s
        bit = MB + ab
        if (GL - 1 - bit if fwd else bit) >= stages:
            continue
        lo_a = np.array([x for x in range(R) if not x >> ab & 1])
        hi_a = lo_a | (1 << ab)
        if fwd:
            t = GL - 1 - bit
            base, C = rotl(c, t, GL) & (H - 1), rotl(lo_a << MB, t, GL) & (H - 1)
            row_w, row_wp = tb["tw"][t], tb["twp"][t]
        else:
            base, C = rotr(c, bit + 1, GL) & (H - 1), rotr(lo_a << MB, bit + 1, GL) & (H - 1)
            row_w, row_wp = tb["tw"][stages - 1 - bit], tb["twp"][stages - 1 - bit]
        assert not np.any(base & C)
        j = base + C
        x0, x1 = (ln.fwd if fwd else ln.inv)(v[..., lo_a], v[..., hi_a], row_w[j], row_wp[j])
        v[..., lo_a], v[..., hi_a] = x0, x1
    pos = o
    if not fwd:
        if stages != GL:
            pos = rotr(o, stages, GL)
        v = _final(v, ln, tb, fwd, pos)
    out = np.zeros_like(X)
    out[np.arange(X.shape[0])[:, None, None], pos] = v
    return out


def emulate_banks(x, pack, *, fwd, negacyclic, lazy, reduce_out, split=None,
                  bits=32, rb=None):
    """The card's transform of x (k, B, n) uint32/uint16 with a TablePack of
    numpy rows: one row-body launch with 2^rb words a thread (default 16,
    fewer below n = 16), or (split = S) the column pass over the top S bits
    and the row body on 2^(L - S)-word chunks."""
    k, b, n = x.shape
    L = n.bit_length() - 1
    names = (("tw", "twp", "psi", "psip") if fwd else ("itw", "itwp", "ipsin", "ipsinp"))
    out = np.zeros(x.shape, dtype=np.uint64)
    for p in range(k):
        tb = {"tw": np.asarray(pack[names[0]][p], np.uint64),
              "twp": np.asarray(pack[names[1]][p], np.uint64),
              "w": np.asarray(pack[names[2]][p], np.uint64),
              "wp": np.asarray(pack[names[3]][p], np.uint64),
              "negacyclic": negacyclic, "reduce_out": reduce_out}
        if not fwd:
            tb["ninv"], tb["ninv_p"] = int(pack["ninv"][p]), int(pack["ninv_p"][p])
        ln = _Lane(int(pack["qs"][p]), bits, lazy)
        X = x[p].astype(np.uint64)
        if split is None:
            out[p] = _emulate_rows(X, ln, tb, fwd, L, L, pre=fwd, final=True,
                                   rb=rb or reg_bits(L))
            continue
        chunks = lambda A: A.reshape(-1, 1 << (L - split))
        if fwd:
            mid = _emulate_cols(X, ln, tb, True, split, L)
            out[p] = _emulate_rows(chunks(mid), ln, tb, True, L - split, L, pre=False,
                                   final=True, rb=reg_bits(L - split)).reshape(b, n)
        else:
            mid = _emulate_rows(chunks(X), ln, tb, False, L - split, L, pre=False,
                                final=False, rb=reg_bits(L - split)).reshape(b, n)
            out[p] = _emulate_cols(mid, ln, tb, False, split, L)
    return out.astype(x.dtype)


def _pack_np(pack, stages=None):
    """A reference pack as numpy rows, its stage tables cut to ``stages``."""
    out = {name: np.asarray(v) for name, v in pack.items()}
    if stages is not None:
        for name in ("tw", "twp", "itw", "itwp"):
            out[name] = out[name][:, :stages]
    return out


def _check_emulation(x, ref_pack, port_pack, *, fwd, split=None, bits=32, rb=None, **kw):
    """The emulation equal to the port's plain version and the reference's
    plain path, word for word."""
    pk = _pack_np(ref_pack)
    got = emulate_banks(x, pk, fwd=fwd, split=split, bits=bits, rb=rb, **kw)
    to_t = u32_to_tensor if bits == 32 else u16_to_tensor
    from_t = tensor_to_u32 if bits == 32 else tensor_to_u16
    op_r, op_p = (RO.ntt_banks, TO.ntt_banks) if fwd else (RO.intt_banks, TO.intt_banks)
    r = op_r(jnp.asarray(x), ref_pack, use_pallas=False, **kw)
    p = op_p(to_t(x, "cpu"), port_pack, **kw)
    assert np.array_equal(got, np.asarray(r)), "emulation != reference"
    assert np.array_equal(got, from_t(p)), "emulation != port plain version"


_EMU = {}


def _emu_packs(n, stages=None):
    """Reference and port packs for 2 primes at n (stage tables cut to
    ``stages``), built once."""
    key = (n, stages)
    if key not in _EMU:
        primes = RR.make_primes(max(n, 16), 2)
        ref = RB.build_table_pack(list(primes), n)
        if stages is not None:
            ref = dict(ref)
            for name in ("tw", "twp", "itw", "itwp"):
                ref[name] = ref[name][:, :stages]
        _EMU[key] = (primes, ref, from_reference(ref, "cpu"))
    return _EMU[key]


@pytest.mark.parametrize("n,stages,rb", [(16, None, None), (128, None, None),
                                         (1024, None, None), (4096, None, None),
                                         (128, 5, None), (4096, 9, None), (16, None, 2),
                                         (128, None, 2), (256, 6, 2)])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("reduce_out", [False, True])
@pytest.mark.parametrize("negacyclic", [False, True])
def test_register_schedule_matches_reference(n, stages, rb, fwd, lazy, reduce_out,
                                             negacyclic):
    """The row body's schedule (u32 lane, every stage, and incomplete
    stage counts; 16 words a thread, and the small-batch body's 4) gives
    the reference's words."""
    primes, ref, port = _emu_packs(n, stages)
    x = _residues(n + 7 * lazy + fwd, primes, (3,), n, band=2 if (lazy and not fwd) else 1)
    _check_emulation(x, ref, port, fwd=fwd, negacyclic=negacyclic, lazy=lazy,
                     reduce_out=reduce_out, rb=rb)


@pytest.mark.parametrize("rb", [4, 2])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("reduce_out", [False, True])
def test_register_schedule_matches_reference_u16(rb, fwd, lazy, reduce_out):
    """ML-KEM's ring on the u16 lane: 7 stages on n = 256, output words at
    rotl^7 / rotr^7 of their indices; 16 and 4 words a thread."""
    from repro.core import ringspec as RS
    from repro_torch.core import ringspec as TS
    ref = RS.ring_table_pack(RS.MLKEM_RING)
    port = from_reference(TS.ring_table_pack(TS.MLKEM_RING), "cpu")
    rng = np.random.default_rng(16 + 2 * fwd + lazy)
    x = rng.integers(0, (2 if (lazy and not fwd) else 1) * 3329, (1, 5, 256)).astype(np.uint16)
    _check_emulation(x, ref, port, fwd=fwd, bits=16, negacyclic=False, lazy=lazy,
                     reduce_out=reduce_out, rb=rb)


@pytest.mark.parametrize("split", [3, 5, 8])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("lazy", [False, True])
def test_two_pass_split_matches_reference(split, fwd, lazy):
    """A ring of 2^15 words in two passes, words kept at their own indices
    between them: the column pass over the top ``split`` bits and the row
    body on 2^(15 - split)-word chunks (the card takes split = L - 12)."""
    n = 1 << 15
    primes, ref, port = _emu_packs(n)
    x = _residues(split + 2 * lazy + fwd, primes, (2,), n,
                  band=2 if (lazy and not fwd) else 1)
    _check_emulation(x, ref, port, fwd=fwd, split=split, negacyclic=True,
                     lazy=lazy, reduce_out=not lazy)


@pytest.mark.parametrize("stages", [2, 9])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
def test_two_pass_split_with_fewer_stages_matches_reference(stages, fwd):
    """Incomplete stage counts on the two-pass route: all in the first
    pass (2), or into the second (9); the last pass places the words."""
    n = 1 << 15
    primes, ref, port = _emu_packs(n, stages)
    x = _residues(stages + fwd, primes, (2,), n)
    _check_emulation(x, ref, port, fwd=fwd, split=3, negacyclic=False, lazy=True,
                     reduce_out=True)


@pytest.mark.parametrize("logn", range(5, 13))
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
def test_swizzled_exchange_is_conflict_free(logn, fwd):
    """Every shared-memory write and read of every exchange touches 32
    distinct banks in each warp of a 256-thread block (rows of TPR
    threads, row stride n + n/16, swz), and the swizzled row is a
    bijection onto its padded stride."""
    n, rb = 1 << logn, reg_bits(logn)
    tpr, R, S = n >> rb, 1 << rb, row_stride(logn)
    threads = max(256, tpr)
    for k in range(1, n_phases(logn, rb)):
        for g in (group(fwd, k - 1, logn, rb), group(fwd, k, logn, rb)):
            idx = [swz(deposit(i, g, rb) | (r << g)) for i in range(tpr) for r in range(R)]
            assert sorted(idx) == list(range(n))
            for r in range(R):
                for w0 in range(0, threads, 32):
                    lanes = [w0 + lane for lane in range(32)]
                    words = [(t // tpr) * S + (swz(deposit(t % tpr, g, rb)) ^ swz(r << g))
                             for t in lanes]
                    assert len({w % 32 for w in words}) == 32, (n, k, g, r, w0)


@pytest.mark.parametrize("negacyclic", [False, True])
def test_single_prime_bank_at_2_15_matches_reference(negacyclic):
    """Above 2^14 the card runs ops.ntt / intt as a one-prime bank: that
    bank, through the banks entry points' plain path, equals the
    reference's ops.ntt / intt at n = 2^15."""
    from repro.core.params import make_ntt_params as ref_params
    from repro_torch.core.params import make_ntt_params
    from repro_torch.kernels import ntt_kernel, ref as TR
    n = 1 << 15
    p, rp = make_ntt_params(n), ref_params(n)
    assert (p.q, p.psi) == (rp.q, rp.psi)
    bank = ntt_kernel.single_prime_bank(p, "cpu")
    rng = np.random.default_rng(15 + negacyclic)
    x = rng.integers(0, p.q, (2, n), dtype=np.uint32)
    for lazy in (False, True):
        kw = dict(negacyclic=negacyclic, lazy=lazy)
        got = TR.ntt_fwd_banks_ref(u32_to_tensor(x, "cpu")[None], bank["qs"], bank["tw"],
                                   bank["twp"], bank["psi"], bank["psip"], negacyclic,
                                   lazy=lazy, reduce_out=True)[0]
        want = RO.ntt(jnp.asarray(x), rp, use_pallas=False, **kw)
        assert np.array_equal(tensor_to_u32(got), np.asarray(want))
        back = TR.ntt_inv_banks_ref(got[None], bank["qs"], bank["ninv"], bank["ninv_p"],
                                    bank["itw"], bank["itwp"], bank["ipsin"],
                                    bank["ipsinp"], negacyclic, lazy=lazy,
                                    reduce_out=True)[0]
        want_back = RO.intt(want, rp, use_pallas=False, **kw)
        assert np.array_equal(tensor_to_u32(back), np.asarray(want_back))
        assert np.array_equal(tensor_to_u32(back), x)
