"""The port's CKKS slice end to end against the JAX reference on the CPU:
with the same seed, keys, ciphertexts and the answers of multiply,
rescale, multiply_many and rescale_many are the same integers, and
decrypt_decode gives the same slots (same numpy decode on identical
integers, so within 1e-9).  One case runs the 2^14 ring, which goes
through the four-step dispatch."""
import numpy as np
import pytest
import torch

from repro.fhe import evalplan as REP
from repro.fhe.ckks import CkksContext as RefContext

from repro_torch.convert import from_reference, tensor_to_u32
from repro_torch.fhe import evalplan as TEP
from repro_torch.fhe.ckks import CkksContext as PortContext

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

SLOT_ATOL = 1e-9


def _poly_equal(r, p):
    return (r.primes == p.primes and r.is_ntt == p.is_ntt
            and np.array_equal(np.asarray(r.data), tensor_to_u32(p.data)))


def _ct_equal(r, p):
    return (_poly_equal(r.c0, p.c0) and _poly_equal(r.c1, p.c1)
            and r.scale == p.scale)


def _slots(seed, count, slots):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
            for _ in range(count)]


def _pair(n, levels, seed):
    ref = RefContext(n=n, levels=levels, seed=seed)
    port = PortContext(n=n, levels=levels, seed=seed, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def ring_2_10():
    ref, port = _pair(1 << 10, 2, seed=5)
    zs = _slots(6, 4, ref.slots)
    # keys first, in the same order on both sides, then the ciphertexts
    ref_keys = ref.plan().relin_key(ref.qs)
    port_keys = port.plan().relin_key(port.qs)
    rc = [ref.encrypt(ref.encode(z)) for z in zs]
    pc = [port.encrypt(port.encode(z)) for z in zs]
    return ref, port, zs, ref_keys, port_keys, rc, pc


def test_keys_equal_reference(ring_2_10):
    ref, port, _, ref_keys, port_keys, _, _ = ring_2_10
    assert ref.qs == port.qs and ref.special == port.special
    assert _poly_equal(ref.pk[0], port.pk[0]) and _poly_equal(ref.pk[1], port.pk[1])
    for r, p in zip(ref_keys, port_keys):
        assert np.array_equal(np.asarray(r), tensor_to_u32(p))


def test_ciphertexts_equal_reference(ring_2_10):
    _, _, _, _, _, rc, pc = ring_2_10
    assert all(_ct_equal(r, p) for r, p in zip(rc, pc))


def test_multiply_rescale_equal_reference(ring_2_10):
    ref, port, zs, _, _, rc, pc = ring_2_10
    rm, pm = ref.multiply(rc[0], rc[1]), port.multiply(pc[0], pc[1])
    assert _ct_equal(rm, pm)
    rr, pr = ref.rescale(rm), port.rescale(pm)
    assert _ct_equal(rr, pr)
    rd, pd = ref.decrypt_decode(rr), port.decrypt_decode(pr)
    np.testing.assert_allclose(pd, rd, rtol=0, atol=SLOT_ATOL)
    np.testing.assert_allclose(pd, zs[0] * zs[1], atol=1e-3)
    assert port.plan().stats["key_switches"] >= 1


def test_multiply_many_rescale_many_equal_reference(ring_2_10):
    ref, port, zs, _, _, rc, pc = ring_2_10
    rhs = [1, 2, 3, 0]
    rm = ref.rescale_many(ref.multiply_many(rc, [rc[j] for j in rhs]))
    pm = port.rescale_many(port.multiply_many(pc, [pc[j] for j in rhs]))
    assert len(pm) == len(rc)
    for i, (r, p) in enumerate(zip(rm, pm)):
        assert _ct_equal(r, p)
        pd = port.decrypt_decode(p)
        np.testing.assert_allclose(pd, ref.decrypt_decode(r), rtol=0, atol=SLOT_ATOL)
        np.testing.assert_allclose(pd, zs[i] * zs[rhs[i]], atol=1e-3)
    # a batch is a loop of single requests, bit for bit
    single = port.rescale(port.multiply(pc[0], pc[1]))
    assert _ct_equal(rm[0], single)


def test_add_sub_and_checks(ring_2_10):
    ref, port, _, _, _, rc, pc = ring_2_10
    assert _ct_equal(ref.add(rc[0], rc[1]), port.add(pc[0], pc[1]))
    assert _ct_equal(ref.sub(rc[0], rc[1]), port.sub(pc[0], pc[1]))
    low = port.rescale(port.multiply(pc[0], pc[1]))
    with pytest.raises(ValueError, match="bases differ"):
        port.multiply(low, pc[2])
    with pytest.raises(ValueError, match="mixes bases"):
        port.rescale_many([low, pc[2]])
    last = port.rescale(low)
    with pytest.raises(ValueError, match="exhausted"):
        port.rescale(last)


def test_port_runs_on_reference_state(ring_2_10):
    """``from_reference``: the reference's packs, stacked relin key and
    ciphertext residue stacks, carried across, drive the port's
    multiply/rescale programs to the reference's own answer."""
    ref, _, _, ref_keys, _, rc, _ = ring_2_10
    plan = ref.plan()
    t, fsp = plan.keyswitch_tables(ref.qs)
    halves = [rc[0].c0.data, rc[0].c1.data, rc[1].c0.data, rc[1].c1.data]
    want = REP.multiply_banks(*halves, *ref_keys, t, fsp, use_pallas=False)
    got = TEP.multiply_banks(*from_reference((*halves, *ref_keys), "cpu"),
                             from_reference(t, "cpu"), None)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), tensor_to_u32(g))
    rt, _ = plan.rescale_tables(ref.qs)
    want_r = REP.rescale_banks(*want, rt, None, use_pallas=False)
    got_r = TEP.rescale_banks(*got, from_reference(rt, "cpu"), None)
    for w, g in zip(want_r, got_r):
        assert np.array_equal(np.asarray(w), tensor_to_u32(g))


def test_ring_2_14_end_to_end():
    """The paper's 2^14 ring (four-step dispatch, natural-order NTT rows):
    multiply -> rescale and the batched twins, bit-identical."""
    ref, port = _pair(1 << 14, 2, seed=11)
    zs = _slots(12, 2, ref.slots)
    rc = [ref.encrypt(ref.encode(z)) for z in zs]
    pc = [port.encrypt(port.encode(z)) for z in zs]
    assert all(_ct_equal(r, p) for r, p in zip(rc, pc))
    rr = ref.rescale(ref.multiply(rc[0], rc[1]))
    pr = port.rescale(port.multiply(pc[0], pc[1]))
    assert _ct_equal(rr, pr)
    rm = ref.rescale_many(ref.multiply_many(rc, rc[::-1]))
    pm = port.rescale_many(port.multiply_many(pc, pc[::-1]))
    assert all(_ct_equal(r, p) for r, p in zip(rm, pm))
    pd = port.decrypt_decode(pr)
    np.testing.assert_allclose(pd, ref.decrypt_decode(rr), rtol=0, atol=SLOT_ATOL)
    np.testing.assert_allclose(pd, zs[0] * zs[1], atol=1e-2)
