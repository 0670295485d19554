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
    assert np.array_equal(TM._TO_FIPS, RM._TO_FIPS) and np.array_equal(TM._TO_CG, RM._TO_CG)


# ---------------------------------------------------------- entry points

def test_keygen_matches_kat():
    ek, dk = TM.keygen_batch(_kat("d"), _kat("z"), device="cpu")
    assert ek.dtype == dk.dtype == np.uint8
    assert ek.shape == (4, TM.EK_BYTES) and dk.shape == (4, TM.DK_BYTES)
    assert np.array_equal(ek, _kat("ek")) and np.array_equal(dk, _kat("dk"))


def test_encaps_matches_kat():
    key, ct = TM.encaps_batch(_kat("ek"), _kat("m"), device="cpu")
    assert key.shape == (4, 32) and ct.shape == (4, TM.CT_BYTES)
    assert np.array_equal(key, _kat("K")) and np.array_equal(ct, _kat("ct"))


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
    key, ct = TM.encaps_batch(ek, m, device="cpu")
    rkey, rct = RM.encaps_batch(ek, m)
    assert np.array_equal(key, rkey) and np.array_equal(ct, rct)
    bad = ct.copy()
    bad[::2, rng.integers(0, TM.CT_BYTES)] ^= 0x10
    got = TM.decaps_batch(dk, bad, device="cpu")
    assert np.array_equal(got, RM.decaps_batch(dk, bad))
    assert np.array_equal(got[1::2], key[1::2]) and not np.array_equal(got[::2], key[::2])


def test_launches_per_entry_point():
    """keygen: 1 forward NTT, 1 basemul; encaps: 1 forward, 2 basemuls,
    2 inverse; decaps: 2 forward, 3 basemuls, 3 inverse — at any batch
    size, and only the u16 lane."""
    b = 3
    rng = np.random.default_rng(5)
    d, z, m = (rng.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(3))
    want = {"keygen": (1, 0, 1), "encaps": (1, 2, 2), "decaps": (2, 3, 3)}
    got = {}
    K.reset_counts()
    ek, dk = TM.keygen_batch(d, z, device="cpu")
    got["keygen"] = K.snapshot()
    K.reset_counts()
    _, ct = TM.encaps_batch(ek, m, device="cpu")
    got["encaps"] = K.snapshot()
    K.reset_counts()
    TM.decaps_batch(dk, ct, device="cpu")
    got["decaps"] = K.snapshot()
    for op, (fwd, inv, mul) in want.items():
        c = got[op]
        assert (c["ntt_fwd_banks_u16"]["plain_calls"], c["ntt_inv_banks_u16"]["plain_calls"],
                c["dyadic_basemul_banks"]["plain_calls"]) == (fwd, inv, mul), op
        others = {k: v for k, v in c.items() if k not in
                  ("ntt_fwd_banks_u16", "ntt_inv_banks_u16", "dyadic_basemul_banks")}
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
