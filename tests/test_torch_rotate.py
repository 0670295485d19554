"""The port's rotation path end to end against the JAX reference on the
CPU: with the same seed and the same prepare, Galois keys, rotations,
conjugations, uniform and mixed ``rotate_many``, ``conjugate_many``,
``rotate_hoisted``, the BSGS ``matvec`` and ``rotate_sum`` give the same
integers, and the plans count the same ``stats``.  The port's programs
also run on the reference's own stacked keys and gather rows, carried
across with ``convert.from_reference``.  At 2^14 (four-step, natural-order
rows) a port-only rotation is held against the slot oracle in tier-1 and
against the reference in the slow suite."""
import numpy as np
import pytest
import torch

from repro.fhe import evalplan as REP
from repro.fhe import linalg as RL
from repro.fhe.ckks import CkksContext as RefContext
from repro.fhe.ckks import galois_poly as ref_galois_poly

from repro_torch import kernels as K
from repro_torch.convert import from_reference, tensor_to_u32
from repro_torch.core.params import galois_eval_perm
from repro_torch.fhe import evalplan as TEP
from repro_torch.fhe import linalg as TL
from repro_torch.fhe import rns
from repro_torch.fhe.ckks import CkksContext as PortContext
from repro_torch.fhe.ckks import galois_poly

torch.set_num_threads(2)

SLOT_ATOL = 1e-9
ROTATIONS = (1, 3, 5)
PREPARE = dict(rotations=ROTATIONS, conjugate=True, hoisted_sets=((0, 3, 3, 5),))


def _poly_equal(r, p):
    return (r.primes == p.primes and r.is_ntt == p.is_ntt
            and np.array_equal(np.asarray(r.data), tensor_to_u32(p.data)))


def _ct_equal(r, p):
    return (_poly_equal(r.c0, p.c0) and _poly_equal(r.c1, p.c1)
            and r.scale == p.scale)


def _all_equal(rs, ps):
    return len(rs) == len(ps) and all(_ct_equal(r, p) for r, p in zip(rs, ps))


def _slots(seed, count, slots):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
            for _ in range(count)]


def _pair(n, levels, seed, **prepare):
    """A reference and a port context with the same seed, each plan
    prepared the same way (so keys are drawn in the same order)."""
    ref = RefContext(n=n, levels=levels, seed=seed)
    port = PortContext(n=n, levels=levels, seed=seed, device="cpu")
    ref.plan().prepare(warm_jit=False, **prepare)
    port.plan().prepare(**prepare)
    return ref, port


@pytest.fixture(scope="module")
def ring_2_10():
    ref, port = _pair(1 << 10, 2, seed=21, **PREPARE)
    zs = _slots(22, 4, ref.slots)
    rc = [ref.encrypt(ref.encode(z)) for z in zs]
    pc = [port.encrypt(port.encode(z)) for z in zs]
    return ref, port, zs, rc, pc


def test_galois_keys_and_rows_equal_reference(ring_2_10):
    ref, port, _, rc, pc = ring_2_10
    assert _all_equal(rc, pc)
    rp, pp = ref.plan(), port.plan()
    gs = [pp.rotation_group_element(r) for r in ROTATIONS] + [2 * port.n - 1]
    assert sorted(pp._idx) == sorted(gs)
    for g in gs:
        for r, p in zip(rp.galois_key(g, ref.qs), pp.galois_key(g, port.qs)):
            assert np.array_equal(np.asarray(r), tensor_to_u32(p)), g
        assert np.array_equal(np.asarray(rp.eval_idx(g)), pp.eval_idx(g).numpy())


def test_automorphism_equals_galois_poly(ring_2_10):
    ref, port, _, rc, pc = ring_2_10
    plan = port.plan()
    for g in (plan.rotation_group_element(3), 2 * port.n - 1):
        got = pc[0].c1.automorphism(plan.eval_idx(g))
        assert _poly_equal(ref_galois_poly(rc[0].c1, g), got)
        assert torch.equal(galois_poly(pc[0].c1, g).data, got.data)
    with pytest.raises(ValueError, match="NTT form"):
        pc[0].c1.to_coeff().automorphism(plan.eval_idx(5))


def test_automorphism_natural_order_2_13():
    """Past the four-step threshold NTT rows are in natural order: the
    gather with the natural-order row equals the coefficient oracle."""
    n = 1 << 13
    primes = tuple(rns.make_primes(n, 2))
    rng = np.random.default_rng(23)
    p = rns.from_int_coeffs(rng.integers(-50, 50, n), primes, n, "cpu").to_ntt()
    for g in (pow(5, 7, 2 * n), 2 * n - 1):
        idx = torch.from_numpy(galois_eval_perm(g, n, True).astype(np.int32))
        assert torch.equal(p.automorphism(idx).data, galois_poly(p, g).data), g


def test_rotate_conjugate_equal_reference(ring_2_10):
    ref, port, zs, rc, pc = ring_2_10
    for r in (1, 5):
        rr, pr = ref.rotate(rc[0], r), port.rotate(pc[0], r)
        assert _ct_equal(rr, pr)
        pd = port.decrypt_decode(pr)
        np.testing.assert_allclose(pd, ref.decrypt_decode(rr), rtol=0, atol=SLOT_ATOL)
        np.testing.assert_allclose(pd, np.roll(zs[0], -r), atol=1e-3)
    rj, pj = ref.conjugate(rc[1]), port.conjugate(pc[1])
    assert _ct_equal(rj, pj)
    np.testing.assert_allclose(port.decrypt_decode(pj), np.conj(zs[1]), atol=1e-3)
    # the identity rotation launches nothing and returns a fresh ciphertext
    K.reset_counts()
    same = port.rotate(pc[2], port.slots)
    assert same is not pc[2] and _ct_equal(rc[2], same)
    assert all(c["plain_calls"] == 0 for c in K.snapshot().values())


@pytest.mark.parametrize("amounts", [(3, 3, 3, 3), (1, 3, 0, 5)],
                         ids=["uniform", "mixed"])
def test_rotate_many_equals_reference(ring_2_10, amounts):
    ref, port, zs, rc, pc = ring_2_10
    rm, pm = ref.rotate_many(rc, list(amounts)), port.rotate_many(pc, list(amounts))
    assert _all_equal(rm, pm)
    # a batch is a loop of single rotations, bit for bit
    assert _all_equal(rm, [port.rotate(c, r) for c, r in zip(pc, amounts)])
    for p, z, r in zip(pm, zs, amounts):
        np.testing.assert_allclose(port.decrypt_decode(p), np.roll(z, -r), atol=1e-3)


def test_conjugate_many_equals_reference(ring_2_10):
    ref, port, zs, rc, pc = ring_2_10
    rm, pm = ref.conjugate_many(rc), port.conjugate_many(pc)
    assert _all_equal(rm, pm)
    np.testing.assert_allclose(port.decrypt_decode(pm[3]), np.conj(zs[3]), atol=1e-3)


def test_rotate_hoisted_equals_reference(ring_2_10):
    """The reference's own pin: identity and repeated amounts ride one
    hoisted pass, bit-identical to a loop of rotations."""
    ref, port, zs, rc, pc = ring_2_10
    rs = [0, 3, 3, 5]
    rh, ph = ref.rotate_hoisted(rc[0], rs), port.rotate_hoisted(pc[0], rs)
    assert _all_equal(rh, ph)
    assert _all_equal(rh, [port.rotate(pc[0], r) for r in rs])
    assert _all_equal(ref.rotate_hoisted(rc[1], [5]), port.rotate_hoisted(pc[1], [5]))
    for p, r in zip(ph, rs):
        np.testing.assert_allclose(port.decrypt_decode(p), np.roll(zs[0], -r), atol=1e-3)


def test_stats_equal_reference(ring_2_10):
    ref, port, _, rc, pc = ring_2_10
    steps = [lambda c, cs: c.rotate(cs[0], 1),
             lambda c, cs: c.conjugate(cs[0]),
             lambda c, cs: c.rotate_many(cs, [1, 3, 1, 0]),
             lambda c, cs: c.conjugate_many(cs[:2]),
             lambda c, cs: c.rotate_hoisted(cs[0], [0, 3, 3, 5])]
    want = [(1, 1, 1), (1, 1, 1), (1, 3, 3), (1, 2, 2), (1, 3, 1)]
    for step, (dsp, ks, dec) in zip(steps, want):
        ref.plan().reset_stats()
        port.plan().reset_stats()
        step(ref, rc)
        step(port, pc)
        assert port.plan().stats == ref.plan().stats
        assert port.plan().stats == {"dispatches": dsp, "key_switches": ks,
                                     "decomposes": dec}


def test_batch_checks(ring_2_10):
    _, port, _, _, pc = ring_2_10
    low = port.rescale(port.multiply(pc[0], pc[1]))
    with pytest.raises(ValueError, match="mixes bases"):
        port.rotate_many([low, pc[2]], [1, 1])
    with pytest.raises(ValueError, match="2 cts vs 1 rs"):
        port.rotate_many(pc[:2], [1])
    assert port.rotate_hoisted(pc[0], []) == []


@pytest.mark.parametrize("shape,n1", [((16, 16), None), ((6, 20), None),
                                      ((20, 6), None), ((10, 10), 4)],
                         ids=["square", "wide", "tall", "short-last-group"])
def test_matvec_and_rotate_sum_equal_reference(shape, n1):
    ref, port = _pair(1 << 10, 1, seed=24)
    rng = np.random.default_rng(25)
    W = rng.uniform(-1, 1, shape)
    x = rng.uniform(-1, 1, shape[0])
    RM = RL.PtMatrix.encode(ref, W, n1=n1)
    PM = TL.PtMatrix.encode(port, W, n1=n1)
    assert (PM.n1, PM.n2, PM.baby_set, PM.giant_set) == \
        (RM.n1, RM.n2, RM.baby_set, RM.giant_set)
    assert all(_poly_equal(RM.diags[k], PM.diags[k]) for k in RM.diags) \
        and sorted(RM.diags) == sorted(PM.diags)
    ref.plan().prepare(warm_jit=False, matvecs=(RM,))
    port.plan().prepare(matvecs=(PM,))
    rv = ref.encrypt(RL.encode_vector(ref, x, shape[1]))
    pv = port.encrypt(TL.encode_vector(port, x, shape[1]))
    assert _ct_equal(rv, pv)
    ry, py = RL.matvec(ref.plan(), RM, rv), TL.matvec(port.plan(), PM, pv)
    assert _ct_equal(ry, py)
    assert port.plan().stats == ref.plan().stats
    np.testing.assert_allclose(port.decrypt_decode(py)[:shape[1]], x @ W, atol=1e-3)
    rs, ps = RL.rotate_sum(ref.plan(), ry, 4), TL.rotate_sum(port.plan(), py, 4)
    assert _ct_equal(rs, ps)
    y = np.zeros(port.slots)
    y[:shape[1]] = x @ W
    np.testing.assert_allclose(port.decrypt_decode(ps)[:8],
                               [y[s:s + 4].sum() for s in range(8)], atol=1e-3)
    assert port.plan().stats == ref.plan().stats


def test_linalg_checks():
    _, port = _pair(1 << 10, 1, seed=26)
    with pytest.raises(ValueError, match="exceeds"):
        TL.PtMatrix.encode(port, np.ones((300, 300)))
    with pytest.raises(ValueError, match="n1="):
        TL.PtMatrix.encode(port, np.ones((4, 4)), n1=5)
    M = TL.PtMatrix.encode(port, np.eye(4), basis=port.qs[:-1])
    ct = port.encrypt(port.encode(np.ones(4)))
    with pytest.raises(ValueError, match="valid at exactly one basis"):
        TL.matvec(port.plan(), M, ct)
    with pytest.raises(ValueError, match="power of two"):
        TL.rotate_sum(port.plan(), ct, 3)
    assert TL.bsgs_split(64) == (8, 8) and TL.bsgs_split(10) == (4, 3)


def test_port_runs_on_reference_state(ring_2_10):
    """``from_reference``: the reference's tables, stacked Galois keys,
    gather rows and ciphertext halves, carried across, drive the port's
    rotation program (one ciphertext as a (1, k, n) stack, then a mixed
    batch of three) to the reference's own answers."""
    ref, _, _, rc, _ = ring_2_10
    plan = ref.plan()
    t, _ = plan.keyswitch_tables(ref.qs)
    tt = from_reference(t, "cpu")
    g = plan.rotation_group_element(3)
    key, idx = plan.galois_key(g, ref.qs), plan.eval_idx(g)
    halves = (rc[0].c0.data, rc[0].c1.data)
    want = REP.galois_ks_banks(*halves, idx, *key, t, None, use_pallas=False)
    got = TEP.galois_ks_many_banks(*(h[None] for h in from_reference(halves, "cpu")),
                                   torch.from_numpy(np.array(idx)),
                                   *from_reference(key, "cpu"), tt, None)
    assert all(g_.shape[0] == 1 and np.array_equal(np.asarray(w), tensor_to_u32(g_[0]))
               for w, g_ in zip(want, got))

    gs = tuple(plan.rotation_group_element(r) for r in (1, 3, 5))
    eb, ea, rows = plan._galois_batch_key(gs, ref.qs)
    stacks = tuple(np.stack([np.asarray(getattr(c, h).data) for c in rc[:3]])
                   for h in ("c0", "c1"))
    want = REP.galois_ks_many_banks(*stacks, rows, eb, ea, t, None, use_pallas=False)
    got = TEP.galois_ks_many_banks(*from_reference(stacks, "cpu"),
                                   torch.from_numpy(np.array(rows)),
                                   *from_reference((eb, ea), "cpu"), tt, None)
    assert all(np.array_equal(np.asarray(w), tensor_to_u32(g_)) for w, g_ in zip(want, got))

    want = REP.hoisted_rotations_banks(*halves, rows, eb, ea, t, None, use_pallas=False)
    got = TEP.hoisted_rotations_banks(*from_reference(halves, "cpu"),
                                      torch.from_numpy(np.array(rows)),
                                      *from_reference((eb, ea), "cpu"), tt, None)
    assert all(np.array_equal(np.asarray(w), tensor_to_u32(g_)) for w, g_ in zip(want, got))


def test_ring_2_14_rotation_slot_oracle():
    """The paper's ring size, port only: a rotation and a hoisted pair
    through the four-step pipeline, against np.roll."""
    port = PortContext(n=1 << 14, levels=1, seed=27, device="cpu")
    z = _slots(28, 1, port.slots)[0]
    ct = port.encrypt(port.encode(z))
    np.testing.assert_allclose(port.decrypt_decode(port.rotate(ct, 3)),
                               np.roll(z, -3), atol=1e-2)
    for r, out in zip((1, 7), port.rotate_hoisted(ct, [1, 7])):
        np.testing.assert_allclose(port.decrypt_decode(out), np.roll(z, -r), atol=1e-2)


@pytest.mark.slow  # the reference compiles its 2^14 hoisted program (~2 min)
def test_ring_2_14_equals_reference():
    ref, port = _pair(1 << 14, 1, seed=29)
    z = _slots(30, 1, ref.slots)[0]
    rc, pc = ref.encrypt(ref.encode(z)), port.encrypt(port.encode(z))
    assert _ct_equal(rc, pc)
    assert _ct_equal(ref.rotate(rc, 3), port.rotate(pc, 3))
    assert _all_equal(ref.rotate_hoisted(rc, [1, 2, 3, 4]),
                      port.rotate_hoisted(pc, [1, 2, 3, 4]))
