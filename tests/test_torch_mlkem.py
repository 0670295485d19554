"""The port's ML-KEM-768 path against the JAX reference on the CPU.

Bit for bit, from the 16-bit modular arithmetic up to the three KEM
entry points: the u16 Shoup/Barrett helpers on the lazy band's edges,
``ring_table_pack(MLKEM_RING)`` and the ``RingSpec`` guards, the u16
``ntt_banks``/``intt_banks`` and ``dyadic_basemul_banks`` against the
reference run as its own tests run it (Pallas in interpret mode, and its
plain path), the checked-in KAT vectors (ek, dk, ct, K and the
implicit-rejection key), and random seeds at an odd batch.  Inputs come
from numpy seeds.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypcompat import given, settings, st

import mlkem_spec as spec

from repro.core import modmath as rm
from repro.core import ringspec as RR
from repro.kernels import ops as RO
from repro.pq import mlkem as RM

from repro_torch import kernels as K
from repro_torch.convert import (from_reference, resolve_device, tensor_to_u16,
                                 u16_to_tensor)
from repro_torch.core import modmath as tm
from repro_torch.core import ringspec as TR
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref
from repro_torch.pq import mlkem as TM

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

Q, N = TM.Q, TM.N
KAT_PATH = os.path.join(os.path.dirname(__file__), "vectors", "mlkem768_kat.json")
REF_PACK = RR.ring_table_pack(RR.MLKEM_RING)
PORT_PACK = from_reference(REF_PACK, "cpu")
EDGES = np.array([0, 1, Q - 1, Q, 2 * Q - 1], dtype=np.uint16)


def _kat(key):
    with open(KAT_PATH) as f:
        vs = json.load(f)["vectors"]
    return np.stack([np.frombuffer(bytes.fromhex(v[key]), np.uint8) for v in vs])


def _rows(seed, shape, band=1):
    return np.random.default_rng(seed).integers(0, band * Q, shape, dtype=np.uint16)


def _same(ref_out, port_out):
    r = np.asarray(ref_out)
    return r.dtype == np.uint16 and np.array_equal(r, tensor_to_u16(port_out))


# ---------------------------------------------------- the 16-bit lane

def test_u16_constants_match_reference():
    assert tm.BARRETT_WINDOWS == rm.BARRETT_WINDOWS
    assert tm.BARRETT_MU_SHIFTS == rm.BARRETT_MU_SHIFTS
    assert tm.SHOUP_SHIFTS == rm.SHOUP_SHIFTS
    for name in ("uint16", "uint32"):
        assert tm.dtype_bits(name) == rm.dtype_bits(name)
    assert tm.dtype_bits(np.uint16) == 16
    with pytest.raises(ValueError, match="unsupported"):
        tm.dtype_bits("uint8")
    assert tm.barrett_precompute(Q, bits=16) == rm.barrett_precompute(Q, bits=16) == 20158
    for w in (0, 1, 17, Q - 1):
        assert tm.shoup_precompute(w, Q, bits=16) == rm.shoup_precompute(w, Q, bits=16)
    for q in (1 << 10, 1 << 12, 7681):
        with pytest.raises(ValueError, match="uint16-lane Barrett range"):
            tm.barrett_precompute(q, bits=16)
    with pytest.raises(ValueError, match="lane width"):
        tm.shoup_precompute(1, Q, bits=8)


def _edge_pairs():
    ws = np.array([0, 1, Q - 1, 17, 1729], dtype=np.uint16)
    x, w = [a.reshape(-1) for a in np.meshgrid(EDGES, ws)]
    a, b = [v.reshape(-1) for v in np.meshgrid(EDGES, EDGES)]
    return x, w, a, b


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("lazy", [False, True])
def test_u16_shoup_band_edges_match_reference(lazy):
    x, w, _, _ = _edge_pairs()
    wp = np.array([rm.shoup_precompute(int(v), Q, bits=16) for v in w], dtype=np.uint16)
    r_fn = rm.mulmod_shoup_lazy if lazy else rm.mulmod_shoup
    t_fn = tm.mulmod_shoup_lazy if lazy else tm.mulmod_shoup
    want = np.asarray(r_fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(wp), jnp.uint16(Q)))
    got = t_fn(_t(x), _t(w), _t(wp), torch.tensor(Q), bits=16).numpy()
    assert want.dtype == np.uint16 and np.array_equal(got, want.astype(np.int64))
    if lazy:
        assert np.array_equal(got, tm.mulmod_shoup_lazy_np(x, w, Q, bits=16))
        assert got.max() < 2 * Q
    else:
        assert np.array_equal(got, x.astype(np.int64) * w % Q)


@pytest.mark.parametrize("lazy", [False, True])
def test_u16_barrett_band_edges_match_reference(lazy):
    _, _, a, b = _edge_pairs()
    mu = rm.barrett_precompute(Q, bits=16)
    r_fn = rm.mulmod_barrett_lazy if lazy else rm.mulmod_barrett
    t_fn = tm.mulmod_barrett_lazy if lazy else tm.mulmod_barrett
    want = np.asarray(r_fn(jnp.asarray(a), jnp.asarray(b), jnp.uint16(Q), jnp.uint16(mu)))
    got = t_fn(_t(a), _t(b), torch.tensor(Q), torch.tensor(mu), bits=16).numpy()
    assert want.dtype == np.uint16 and np.array_equal(got, want.astype(np.int64))
    if lazy:
        assert np.array_equal(got, tm.mulmod_barrett_lazy_np(a, b, Q, bits=16))
        assert got.max() < 2 * Q
    else:
        assert np.array_equal(got, a.astype(np.int64) * b % Q)


@settings(max_examples=50, deadline=None, database=None)
@given(x=st.integers(0, 2 * Q - 1), w=st.integers(0, Q - 1), a=st.integers(0, Q - 1))
def test_u16_helpers_property(x, w, a):
    wp = tm.shoup_precompute(w, Q, bits=16)
    mu = tm.barrett_precompute(Q, bits=16)
    q = torch.tensor(Q)
    args = (torch.tensor(x), torch.tensor(w), torch.tensor(wp), q)
    assert int(tm.mulmod_shoup(*args, bits=16)) == x * w % Q
    lazy = int(tm.mulmod_shoup_lazy(*args, bits=16))
    assert lazy == int(tm.mulmod_shoup_lazy_np(x, w, Q, bits=16)) and lazy < 2 * Q
    bl = int(tm.mulmod_barrett_lazy(torch.tensor(a), torch.tensor(w), q,
                                    torch.tensor(mu), bits=16))
    assert bl == int(tm.mulmod_barrett_lazy_np(a, w, Q, bits=16)) and bl % Q == a * w % Q


def test_u16_bit_pattern_rule():
    """Shoup companions above 2^15 ride as int16 bit patterns and come
    back unchanged; the lane widens them with & 0xFFFF."""
    a = np.array([0, 1, 2**15 - 1, 2**15, 2**16 - 1], dtype=np.uint16)
    t = u16_to_tensor(a, "cpu")
    assert t.dtype == torch.int16
    assert t.tolist() == [0, 1, 2**15 - 1, -2**15, -1]
    assert np.array_equal(tensor_to_u16(t), a)
    assert tm.u16(t).tolist() == [int(v) for v in a]
    with pytest.raises(ValueError):
        u16_to_tensor(np.array([70000]), "cpu")


# ------------------------------------------------------ ring descriptor

def test_ring_table_pack_equals_reference():
    port = TR.ring_table_pack(TR.MLKEM_RING)
    assert set(port) == set(REF_PACK)
    for key, want in REF_PACK.items():
        want = np.asarray(want)
        assert port[key].dtype == want.dtype == np.uint16, key
        assert np.array_equal(port[key], want), key
        assert PORT_PACK[key].dtype == torch.int16, key
        assert np.array_equal(tensor_to_u16(PORT_PACK[key]), want), key
    assert int(port["twp"].max()) > 2**15      # companions use the top bit
    spec = TR.MLKEM_RING
    assert (spec.stages, spec.bits, spec.incomplete, spec.lazy_band) == (7, 16, True, 2 * Q)
    assert dict(vars(spec)) == dict(vars(RR.MLKEM_RING))


def test_ringspec_rejections_match_reference():
    bad = [dict(n=256, q=3328, dtype="uint16", block=2),     # no order-256 root
           dict(n=256, q=7681, dtype="uint16", block=2),     # over the u16 window
           dict(n=256, q=3329, dtype="uint16", block=3),
           dict(n=255, q=3329, dtype="uint16", block=2),
           dict(n=256, q=3329, dtype="uint16", block=2, zeta=16),
           dict(n=256, q=3329, dtype="uint8", block=2)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            RR.RingSpec(name="bad", **kw)
        with pytest.raises(ValueError) as got:
            TR.RingSpec(name="bad", **kw)
        assert str(got.value) == str(want.value), kw
    # a derived root gives the reference's pack too
    spec = dict(name="derived", n=64, q=3329, dtype="uint16", block=2)
    ref = RR.ring_table_pack(RR.RingSpec(**spec))
    port = TR.ring_table_pack(TR.RingSpec(**spec))
    assert all(np.array_equal(port[k], np.asarray(ref[k])) for k in ref)


# ------------------------------------------ kernels' entry points, u16

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_u16_ntt_banks_match_reference(use_pallas, lazy):
    """Forward and inverse at an odd batch, both reduce_out settings; the
    inverse also takes the [0, 2q) band in lazy mode."""
    x = _rows(1, (1, 5, N))
    xin = _rows(2, (1, 5, N), band=2 if lazy else 1)
    for reduce_out in (False, True):
        kw = dict(negacyclic=False, lazy=lazy, reduce_out=reduce_out)
        r = RO.ntt_banks(jnp.asarray(x), REF_PACK, use_pallas=use_pallas, **kw)
        p = TO.ntt_banks(u16_to_tensor(x, "cpu"), PORT_PACK, **kw)
        assert _same(r, p), ("fwd", reduce_out)
        r = RO.intt_banks(jnp.asarray(xin), REF_PACK, use_pallas=use_pallas, **kw)
        p = TO.intt_banks(u16_to_tensor(xin, "cpu"), PORT_PACK, **kw)
        assert _same(r, p), ("inv", reduce_out)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_u16_basemul_matches_reference(use_pallas):
    a, b = _rows(3, (1, 5, N)), _rows(4, (1, 5, N))
    for lazy in (False, True):
        r = RO.dyadic_basemul_banks(jnp.asarray(a), jnp.asarray(b), REF_PACK,
                                    use_pallas=use_pallas, lazy=lazy)
        p = TO.dyadic_basemul_banks(u16_to_tensor(a, "cpu"), u16_to_tensor(b, "cpu"),
                                    PORT_PACK, lazy=lazy)
        assert _same(r, p), lazy
    # (b, k, ..., n) stacks, both operands swapped
    a2, b2 = _rows(5, (3, 1, 2, N)), _rows(6, (3, 1, 2, N))
    r = RO.dyadic_basemul_banks(jnp.asarray(a2), jnp.asarray(b2), REF_PACK,
                                batch_leading=True, use_pallas=use_pallas)
    p = TO.dyadic_basemul_banks(u16_to_tensor(a2, "cpu"), u16_to_tensor(b2, "cpu"),
                                PORT_PACK, batch_leading=True)
    assert p.shape == a2.shape and _same(r, p)


def test_u16_ntt_batch_leading_matches_reference():
    x = _rows(7, (3, 1, N))
    for fn_r, fn_p in ((RO.ntt_banks, TO.ntt_banks), (RO.intt_banks, TO.intt_banks)):
        r = fn_r(jnp.asarray(x), REF_PACK, negacyclic=False, use_pallas=False,
                 batch_leading=True)
        p = fn_p(u16_to_tensor(x, "cpu"), PORT_PACK, negacyclic=False,
                 batch_leading=True)
        assert _same(r, p)


def test_ring_algebra_matches_reference():
    """The module's kernel-routed helpers on an odd number of rows."""
    x, a, b = _rows(8, (5, N)), _rows(9, (5, N)), _rows(10, (5, N))
    t = lambda v: u16_to_tensor(v, "cpu")
    assert _same(RM._ntt_rows(x), TM._ntt_rows(t(x)))
    assert _same(RM._intt_rows(x), TM._intt_rows(t(x)))
    assert _same(RM._basemul_rows(a, b), TM._basemul_rows(t(a), t(b)))
    ah, yh = _rows(11, (5, 3, 3, N)), _rows(12, (5, 3, N))
    assert _same(RM._matvec_hat(ah, yh), TM._matvec_hat(t(ah), t(yh)))
    assert _same(RM._dot_hat(ah[:, 0], yh), TM._dot_hat(t(ah[:, 0]), t(yh)))
    # the FIPS -> CG order the sampler and the codec kernels store in
    cg = ref.cg_index().numpy()
    assert np.array_equal(cg, RM._TO_FIPS) and np.array_equal(np.argsort(cg), RM._TO_CG)


# ---------------------------------------------------------- entry points

def test_keygen_matches_kat():
    ek, dk = TM.keygen_batch(_kat("d"), _kat("z"), device="cpu")
    assert ek.dtype == dk.dtype == np.uint8
    assert ek.shape == (4, TM.EK_BYTES) and dk.shape == (4, TM.DK_BYTES)
    assert np.array_equal(ek, _kat("ek")) and np.array_equal(dk, _kat("dk"))


def test_encaps_matches_kat():
    key, ct, ok = TM.encaps_batch(_kat("ek"), _kat("m"), device="cpu")
    assert key.shape == (4, 32) and ct.shape == (4, TM.CT_BYTES)
    assert np.array_equal(key, _kat("K")) and np.array_equal(ct, _kat("ct"))
    assert ok.dtype == np.bool_ and ok.all()


def test_decaps_matches_kat_and_implicit_rejection():
    assert np.array_equal(TM.decaps_batch(_kat("dk"), _kat("ct"), device="cpu"),
                          _kat("K"))
    bad = _kat("ct").copy()
    bad[:, 17] ^= 0x01
    assert np.array_equal(TM.decaps_batch(_kat("dk"), bad, device="cpu"),
                          _kat("K_reject_flip_ct_byte17_bit0"))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_seeds_match_reference_bytes(seed):
    """b = 5 (odd): every output byte equal to the reference's, a tampered
    ciphertext included."""
    rng = np.random.default_rng(seed)
    d, z, m = (rng.integers(0, 256, (5, 32), dtype=np.uint8) for _ in range(3))
    ek, dk = TM.keygen_batch(d, z, device="cpu")
    rek, rdk = RM.keygen_batch(d, z)
    assert np.array_equal(ek, rek) and np.array_equal(dk, rdk)
    key, ct, ok = TM.encaps_batch(ek, m, device="cpu")
    rkey, rct = RM.encaps_batch(ek, m)
    assert ok.all()
    assert np.array_equal(key, rkey) and np.array_equal(ct, rct)
    bad = ct.copy()
    bad[::2, rng.integers(0, TM.CT_BYTES)] ^= 0x10
    got = TM.decaps_batch(dk, bad, device="cpu")
    assert np.array_equal(got, RM.decaps_batch(dk, bad))
    assert np.array_equal(got[1::2], key[1::2]) and not np.array_equal(got[::2], key[::2])


def test_launches_per_entry_point():
    """keygen: 1 forward NTT, 1 basemul, 2 Keccak hashes (G, H), 1
    SampleNTT, 1 PRF + CBD; encaps: 1 forward, 2 basemuls, 2 inverse, 2
    hashes (H, G), 1 SampleNTT, 2 PRF + CBD (y; e1 and e2), the key's
    decode and check, the ciphertext's encode; decaps: 2 forward, 3
    basemuls, 3 inverse, 2 hashes (G, J), 1 SampleNTT, 2 PRF + CBD, 2
    decodes (ŝ, the re-encryption's t̂), 1 encode — at any batch size,
    only the u16 lane, and no other kernel."""
    names = ("ntt_fwd_banks_u16", "ntt_inv_banks_u16", "dyadic_basemul_banks",
             "keccak_hash", "keccak_sample_ntt", "keccak_prf_cbd", "mlkem_decode_check",
             "mlkem_encaps_tail")
    want = {"keygen": (1, 0, 1, 2, 1, 1, 0, 0), "encaps": (1, 2, 2, 2, 1, 2, 1, 1),
            "decaps": (2, 3, 3, 2, 1, 2, 2, 1)}
    for b in (1, 3):
        rng = np.random.default_rng(5)
        d, z, m = (rng.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(3))
        got = {}
        K.reset_counts()
        ek, dk = TM.keygen_batch(d, z, device="cpu")
        got["keygen"] = K.snapshot()
        K.reset_counts()
        _, ct, _ = TM.encaps_batch(ek, m, device="cpu")
        got["encaps"] = K.snapshot()
        K.reset_counts()
        TM.decaps_batch(dk, ct, device="cpu")
        got["decaps"] = K.snapshot()
        for op, counts in want.items():
            c = got[op]
            assert tuple(c[k]["plain_calls"] for k in names) == counts, (op, b)
            others = {k: v for k, v in c.items() if k not in names}
            assert all(v == {"launches": 0, "plain_calls": 0} for v in others.values()), op


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seeds = np.zeros((1, 32), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.keygen_batch(seeds, seeds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.encaps_batch(np.zeros((1, TM.EK_BYTES), np.uint8), seeds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.decaps_batch(np.zeros((1, TM.DK_BYTES), np.uint8),
                        np.zeros((1, TM.CT_BYTES), np.uint8))
    assert resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------- the device-resident path

def _malformed(ek: np.ndarray, rows, values, seed=0):
    """ek with one 12-bit coefficient of each listed row set to a value at
    q or above, at a seeded coefficient: FIPS 203 §7.2 rejects it."""
    ek = ek.copy()
    rng = np.random.default_rng(seed)
    for r, v in zip(rows, values):
        c = int(rng.integers(0, 3 * 256))            # polynomial c // 256, pair c // 2
        o = 3 * (c // 2)
        if c % 2 == 0:
            ek[r, o] = v & 255
            ek[r, o + 1] = (ek[r, o + 1] & 0xF0) | (v >> 8)
        else:
            ek[r, o + 1] = (ek[r, o + 1] & 0x0F) | ((v & 15) << 4)
            ek[r, o + 2] = v >> 4
    return ek


def _modulus_check(ek: bytes) -> bool:
    """FIPS 203 §7.2: ByteEncode12(ByteDecode12(ek)) == ek, from the oracle."""
    polys = [[x % spec.Q for x in spec.byte_decode(12, ek[384 * i:384 * (i + 1)])]
             for i in range(3)]
    return b"".join(spec.byte_encode(12, p) for p in polys) == ek[:1152]


def test_malformed_keys_are_rejected_alone():
    """Rows whose key has one coefficient at q, at 4095 or just above q,
    among KAT rows: ok False and zero K and ct there, every other row the
    KAT's bytes; the verdicts are the oracle's §7.2 check."""
    ek = np.concatenate([_kat("ek")] * 2)
    m = np.concatenate([_kat("m")] * 2)
    bad_rows = (1, 4, 6)
    ek = _malformed(ek, bad_rows, (Q, 4095, Q + 1))
    key, ct, ok = TM.encaps_batch(ek, m, device="cpu")
    assert ok.tolist() == [_modulus_check(bytes(r)) for r in ek]
    assert [r for r in range(8) if not ok[r]] == list(bad_rows)
    assert not key[list(bad_rows)].any() and not ct[list(bad_rows)].any()
    good = [r for r in range(8) if ok[r]]
    assert np.array_equal(key[good], np.concatenate([_kat("K")] * 2)[good])
    assert np.array_equal(ct[good], np.concatenate([_kat("ct")] * 2)[good])


def test_the_path_uses_no_hashlib_and_reads_nothing_back(monkeypatch):
    """With hashlib's constructors made to raise and every way of reading
    a tensor back to the host (``.cpu``, ``.numpy``, ``.item``,
    ``.tolist``) made to raise, tensor inputs give the KATs' bytes and
    the oracle's on seeded rows from all three entry points, and a
    malformed key its verdict."""
    import hashlib

    def boom(*a, **kw):
        raise AssertionError("the ML-KEM path called hashlib or read a tensor back")

    rng = np.random.default_rng(17)
    d, z, m = (rng.integers(0, 256, (3, 32), dtype=np.uint8) for _ in range(3))
    want_keys = [spec.keygen(bytes(d[i]), bytes(z[i])) for i in range(3)]
    want_encaps = [spec.encaps(want_keys[i][0], bytes(m[i])) for i in range(3)]
    for name in ("sha3_256", "sha3_512", "shake_128", "shake_256", "new"):
        monkeypatch.setattr(hashlib, name, boom)
    t = lambda key: torch.from_numpy(_kat(key))
    bad_ek = torch.from_numpy(_malformed(_kat("ek"), (2,), (Q,)))
    with monkeypatch.context() as mp:
        for name in ("cpu", "numpy", "item", "tolist"):
            mp.setattr(torch.Tensor, name, boom)
        ek, dk = TM.keygen_batch(t("d"), t("z"))
        key, ct, ok = TM.encaps_batch(t("ek"), t("m"))
        back = TM.decaps_batch(t("dk"), t("ct"))
        _, _, bad_ok = TM.encaps_batch(bad_ek, t("m"))
        r_ek, r_dk = TM.keygen_batch(*map(torch.from_numpy, (d, z)))
        r_key, r_ct, _ = TM.encaps_batch(r_ek, torch.from_numpy(m))
        r_back = TM.decaps_batch(r_dk, r_ct)
    for got, want in ((ek, "ek"), (dk, "dk"), (key, "K"), (ct, "ct"), (back, "K")):
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), _kat(want)), want
    assert ok.all() and bad_ok.tolist() == [True, True, False, True]
    for i in range(3):
        assert (bytes(r_ek[i].numpy()), bytes(r_dk[i].numpy())) == want_keys[i]
        assert (bytes(r_key[i].numpy()), bytes(r_ct[i].numpy())) == want_encaps[i]
    assert torch.equal(r_back, r_key)
    assert "hashlib" not in vars(TM)


KERNEL_ENTRY_POINTS = ("keccak_sha3_256", "keccak_sha3_512", "keccak_shake256",
                      "keccak_sample_ntt", "keccak_prf_cbd", "ntt_banks", "intt_banks",
                      "dyadic_basemul_banks", "mlkem_decode_check", "mlkem_encaps_tail")


def test_no_work_a_row(monkeypatch):
    """The module issues the same torch operations and kernel calls at b =
    1 and b = 6 (each kernel entry point one call, whatever its plain
    version runs inside): nothing on the path loops over rows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen, inside = [], [0]

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0]:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def opaque(name, fn):
        def call(*args, **kw):
            seen.append(name)
            inside[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                inside[0] -= 1
        return call

    for name in KERNEL_ENTRY_POINTS:
        monkeypatch.setattr(TO, name, opaque(name, getattr(TO, name)))

    def ops_at(b):
        rng = np.random.default_rng(b)
        d, z, m = (torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8))
                   for _ in range(3))
        seen.clear()
        with Ops():
            ek, dk = TM.keygen_batch(d, z)
            _, ct, _ = TM.encaps_batch(ek, m)
            TM.decaps_batch(dk, ct)
        return list(seen)

    small, large = ops_at(1), ops_at(6)
    assert small == large
    assert sum(x in KERNEL_ENTRY_POINTS for x in small) == 6 + 12 + 16


def test_spans_and_counters():
    """``mlkem.<op>`` spans with b around their hash / sample / ring /
    codec children, ``mlkem.rows.<op>`` and the permutations launched
    (44 a row for encaps)."""
    from repro_torch import obs
    rng = np.random.default_rng(9)
    d, z, m = (rng.integers(0, 256, (2, 32), dtype=np.uint8) for _ in range(3))
    ek, dk = TM.keygen_batch(d, z, device="cpu")
    obs.enable()
    obs.clear()
    obs.reset()
    try:
        _, ct, _ = TM.encaps_batch(ek, m, device="cpu")
        TM.decaps_batch(dk, ct, device="cpu")
        TM.keygen_batch(d, z, device="cpu")
        events = obs.events()
        counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
        obs.clear()
        obs.reset()
    top = [(e["name"], e["args"].get("b")) for e in events if e["depth"] == 0]
    assert top == [("mlkem.encaps", 2), ("mlkem.decaps", 2), ("mlkem.keygen", 2)]
    kids = {e["name"] for e in events if e["depth"] == 1}
    assert kids == {"mlkem.hash", "mlkem.sample", "mlkem.ring", "mlkem.codec"}
    assert TM.PERMS == {"keygen": 43, "encaps": 44, "decaps": 44}
    assert counters["mlkem.rows.encaps"] == counters["mlkem.rows.decaps"] == 2
    assert counters["mlkem.keccak_perms"] == 2 * (44 + 44 + 43)


def test_entry_points_refuse_wrong_rows():
    with pytest.raises(ValueError, match=r"ek must be \(b, 1184\) uint8"):
        TM.encaps_batch(np.zeros((2, 1183), np.uint8), np.zeros((2, 32), np.uint8),
                        device="cpu")
    with pytest.raises(ValueError, match="m must be"):
        TM.encaps_batch(torch.zeros((2, 1184), dtype=torch.uint8),
                        torch.zeros((2, 32), dtype=torch.int16))
    with pytest.raises(ValueError, match="device=meta"):
        TM.decaps_batch(torch.zeros((1, 2400), dtype=torch.uint8),
                        torch.zeros((1, 1088), dtype=torch.uint8), device="meta")


# ----------------------------------------------------- the codec kernels

def test_decode_check_equals_the_oracle():
    """ByteDecode12 mod q in CG order and §7.2's verdict, on KAT keys with
    malformed rows, and read in place from decapsulation key rows."""
    from repro_torch.kernels import codec_kernel
    ek = _malformed(np.concatenate([_kat("ek")] * 2), (0, 5), (Q, 4095))
    t_hat, ok = codec_kernel.decode_check(torch.from_numpy(ek))
    assert t_hat.dtype == torch.int16 and ok.dtype == torch.bool
    assert ok.tolist() == [_modulus_check(bytes(r)) for r in ek]
    cg = np.argsort(ref.cg_index().numpy())
    for r in range(len(ek)):
        for i in range(3):
            want = [x % Q for x in spec.byte_decode(12, bytes(ek[r, 384 * i:384 * (i + 1)]))]
            assert np.array_equal(t_hat[r, i].numpy(), np.asarray(want)[cg]), (r, i)
    dk = torch.from_numpy(_kat("dk"))
    s_hat, s_ok = codec_kernel.decode_check(dk)
    assert torch.equal(s_hat, codec_kernel.decode_check(dk[:, :1152].contiguous())[0])
    assert s_ok.all()


def test_encaps_tail_equals_the_oracle():
    """Compress and ByteEncode of u + e1 and v + e2 + Decompress1(m) as the
    oracle computes them, K from kr, and zeroed rows where ok is False."""
    from repro_torch.kernels import codec_kernel
    rng = np.random.default_rng(41)
    b = 5
    u, e = rng.integers(0, Q, (b, 3, N)), rng.integers(0, Q, (b, 4, N))
    v = rng.integers(0, Q, (b, N))
    m, kr = rng.integers(0, 256, (b, 32), dtype=np.uint8), rng.integers(0, 256, (b, 64),
                                                                         dtype=np.uint8)
    ok = np.array([True, False, True, True, False])
    t16 = lambda a: torch.from_numpy(a.astype(np.int16))
    key, ct = codec_kernel.encaps_tail(t16(u), t16(v), t16(e), torch.from_numpy(m),
                                       torch.from_numpy(kr), torch.from_numpy(ok))
    for r in range(b):
        mu = [spec.decompress(1, x) for x in spec.byte_decode(1, bytes(m[r]))]
        want = b"".join(spec.byte_encode(10, [spec.compress(10, (x + y) % Q)
                                              for x, y in zip(u[r, i], e[r, i])])
                        for i in range(3))
        want += spec.byte_encode(4, [spec.compress(4, (x + y + z) % Q)
                                     for x, y, z in zip(v[r], e[r, 3], mu)])
        assert bytes(ct[r].numpy()) == (want if ok[r] else bytes(1088)), r
        assert bytes(key[r].numpy()) == (bytes(kr[r, :32]) if ok[r] else bytes(32)), r
    none, ct_all = codec_kernel.encaps_tail(t16(u), t16(v), t16(e), torch.from_numpy(m))
    assert none is None and torch.equal(ct_all[ok], ct[ok]) and ct_all[~ok].any()


@pytest.mark.parametrize("name", ["mlkem_decode_check", "mlkem_encaps_tail"])
def test_codec_meta_branch_records_one_launch(name):
    from repro_torch.kernels import codec_kernel
    from repro_torch.runtime import op_cost
    z = lambda *shape, dt=torch.int16: torch.zeros(shape, dtype=dt, device="meta")
    call = {"mlkem_decode_check": lambda: codec_kernel.decode_check(z(4, 2400, dt=torch.uint8)),
            "mlkem_encaps_tail": lambda: codec_kernel.encaps_tail(
                z(4, 3, N), z(4, N), z(4, 4, N), z(4, 32, dt=torch.uint8),
                z(4, 64, dt=torch.uint8), z(4, dt=torch.bool))}[name]
    K.reset_counts()
    with op_cost.OpCounter() as c:
        first, second = call()
    assert c.kernels == {name: 1}
    assert all(v == {"launches": 0, "plain_calls": 0} for v in K.snapshot().values())
    shapes = {"mlkem_decode_check": ((4, 3, N), (4,)), "mlkem_encaps_tail": ((4, 32), (4, 1088))}
    assert (tuple(first.shape), tuple(second.shape)) == shapes[name]


@pytest.mark.parametrize("call, match", [
    (lambda z: TO.mlkem_decode_check(z(3, 1151, dt=torch.uint8)), "fewer than 1152"),
    (lambda z: TO.mlkem_encaps_tail(z(3, 3, N).int(), z(3, N), z(3, 4, N),
                                    z(3, 32, dt=torch.uint8)), "int16"),
    (lambda z: TO.mlkem_encaps_tail(z(3, 3, N), z(3, N), z(3, 3, N),
                                    z(3, 32, dt=torch.uint8)), "shape"),
    (lambda z: TO.mlkem_encaps_tail(z(3, 3, N), z(3, N), z(3, 4, N),
                                    z(3, 32, dt=torch.uint8), z(3, 31, dt=torch.uint8)), "kr rows"),
    (lambda z: TO.mlkem_encaps_tail(z(3, 3, N), z(3, N), z(3, 4, N),
                                    z(3, 32, dt=torch.uint8), ok=z(3, dt=torch.uint8)), "bool"),
])
def test_codec_wrappers_refuse(call, match):
    z = lambda *shape, dt=torch.int16: torch.zeros(shape, dtype=dt)
    with pytest.raises(K.KernelRefusal, match=match):
        call(z)
