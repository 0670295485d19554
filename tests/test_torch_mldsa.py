"""ML-DSA-65 (FIPS 204) on the port's CPU path against the benchmark's
plain reference (``bench/reference/mldsa.py``, plain Python with
``hashlib``): keygen and signing byte for byte with equal iteration
counts, the slot stream's refills, idle drain and output ring, the
reference's Verify on the port's signatures, the u32 lane's 23-bit
Barrett trait, ``MLDSA_RING``'s transforms against FIPS 204's NTT, the
new Keccak entries' plain versions against ``hashlib``, a round on
``meta`` tensors with every read-back made to raise, and the ``mldsa.*``
spans and counters."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.obs import metrics
from repro_torch.convert import from_reference
from repro_torch.core import modmath as tm
from repro_torch.core.ringspec import MLDSA_RING, RingSpec, ring_table_pack
from repro_torch.kernels import COUNTS, build, ops, ref
from repro_torch.pq import codec, mldsa
from repro_torch.runtime import op_cost

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))
from reference import mldsa as R  # noqa: E402

Q = R.Q


@pytest.fixture(scope="module")
def keys():
    """Two keys from seeded xi, by the port and by the reference."""
    xi = np.random.default_rng(1).integers(0, 256, (2, 32), dtype=np.uint8)
    pk, sk = mldsa.keygen_batch(xi, device="cpu")
    return xi, pk, sk


def _requests(seed, b, m=132):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, m), dtype=np.uint8),
            rng.integers(0, 256, (b, 32), dtype=np.uint8))


# ----------------------------------------------- the lane and the ring

def test_barrett23_window_and_products():
    """bits=23: mu = floor(2^53 / q) inside (2^21, 2^23), products in the
    [0, 2q) band equal to the numpy oracle and exact mod q at the edges;
    the RNS and u16 windows unchanged."""
    assert tm.BARRETT_WINDOWS == {32: (1 << 28, 1 << 30), 16: (1 << 10, 1 << 12)}
    mu = tm.barrett_precompute(Q, bits=23)
    assert mu == (1 << 53) // Q == 1074791296 and mu < 1 << 32
    for q in ((1 << 21), (1 << 23), 3329, 1 << 29):
        with pytest.raises(ValueError, match="uint23-lane Barrett range"):
            tm.barrett_precompute(q, bits=23)
    assert tm.barrett_bits(Q, 32) == 23 and tm.barrett_bits(1 << 29 | 1, 32) == 32
    with pytest.raises(ValueError, match="no Barrett window"):
        tm.barrett_bits(1 << 24, 32)
    edges = np.array([0, 1, 2, Q // 2, Q - 2, Q - 1], dtype=np.int64)
    rand = np.random.default_rng(2).integers(0, Q, 4000)
    a = np.concatenate([np.repeat(edges, len(edges)), rand])
    b = np.concatenate([np.tile(edges, len(edges)), rand[::-1]])
    ta, tb, q, tmu = torch.from_numpy(a), torch.from_numpy(b), torch.tensor(Q), torch.tensor(mu)
    lazy = tm.mulmod_barrett_lazy(ta, tb, q, tmu, bits=23).numpy()
    assert np.array_equal(lazy, tm.mulmod_barrett_lazy_np(a, b, Q, bits=23))
    assert lazy.max() < 2 * Q and np.array_equal(lazy % Q, a * b % Q)
    assert np.array_equal(tm.mulmod_barrett(ta, tb, q, tmu, bits=23).numpy(), a * b % Q)


def test_mldsa_ring_spec_and_pack():
    """MLDSA_RING: a complete transform on the u32 lane at q = 8380417 (the
    23-bit trait), zeta = 1753 of order 512; a u32 modulus outside both
    windows is refused."""
    spec = MLDSA_RING
    assert (spec.n, spec.q, spec.bits, spec.barrett_bits, spec.stages, spec.incomplete) == \
        (256, Q, 32, 23, 8, False)
    pack = ring_table_pack(spec)
    assert pack["mu"][0] == (1 << 53) // Q and pack["ninv"][0] == R.N_INV
    assert pack["tw"].dtype == np.uint32 and pack["tw"].shape == (1, 8, 128)
    with pytest.raises(ValueError, match="outside the uint32 ring window"):
        RingSpec(name="bad", n=256, q=(1 << 24) - 3, dtype="uint32")


def test_port_ntt_is_fips204_ntt():
    """The banks' forward transform on MLDSA_RING's pack is FIPS 204's NTT
    (Alg. 41) in FIPS 204's own order, the inverse its Alg. 42; products in
    the NTT domain are negacyclic products."""
    t = from_reference(ring_table_pack(MLDSA_RING), "cpu")
    rng = np.random.default_rng(3)
    x = rng.integers(0, Q, (4, 256))
    got = ops.ntt_banks(torch.from_numpy(x.astype(np.int32))[None], t, negacyclic=False)[0]
    assert [row.tolist() for row in got.long()] == [R.ntt(list(r)) for r in x]
    back = ops.intt_banks(got[None], t, negacyclic=False)[0]
    assert np.array_equal(back.numpy(), x)
    want = R.intt(R.pointwise(R.ntt(list(x[0])), R.ntt(list(x[1]))))
    prod = np.zeros(512, dtype=object)
    for i in range(256):
        prod[i:i + 256] += int(x[0][i]) * x[1].astype(object)
    assert want == [int(v) % Q for v in prod[:256] - prod[256:]]


# ------------------------------------------------ Keccak and the codec

def test_keccak_plain_versions_equal_hashlib():
    """ExpandMask, SampleInBall, ExpandA, ExpandS and the refill hashes'
    plain versions against the reference, whose XOFs are hashlib's."""
    rng = np.random.default_rng(4)
    rho = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    kappa = np.array([0, 5, 65533], dtype=np.int32)
    y = ref.expand_mask_ref(torch.from_numpy(rho), torch.from_numpy(kappa))
    for i in range(3):
        want = [[c % Q for c in R.bit_unpack(hashlib.shake_256(
            bytes(rho[i]) + ((int(kappa[i]) + r) % 65536).to_bytes(2, "little")).digest(640),
            R.GAMMA1 - 1, R.GAMMA1)] for r in range(5)]
        assert y[i].tolist() == want
    ct = rng.integers(0, 256, (4, 48), dtype=np.uint8)
    c = ref.sample_in_ball_ref(torch.from_numpy(ct))
    assert [r.tolist() for r in c] == [R.sample_in_ball(bytes(r)) for r in ct]
    assert ((c != 0).sum(1) == 49).all()
    seed = rng.integers(0, 256, (2, 64), dtype=np.uint8)
    a = ref.rej_ntt_poly_ref(torch.from_numpy(seed[:, :32]))
    s = ref.rej_bounded_ref(torch.from_numpy(seed), 0, 11)
    for i in range(2):
        assert [[p.tolist() for p in row] for row in a[i]] == R.expand_a(bytes(seed[i, :32]))
        s1, s2 = R.expand_s(bytes(seed[i]))
        assert s[i].tolist() == [[v % Q for v in p] for p in s1 + s2]
    msg, rnd = _requests(5, 6)
    tr, key = rng.integers(0, 256, 64, dtype=np.uint8), rng.integers(0, 256, 32, dtype=np.uint8)
    mu = torch.zeros((5, 64), dtype=torch.uint8)
    rr = torch.zeros((5, 64), dtype=torch.uint8)
    slots, reqs = torch.tensor([2, 0, 3, 1]), torch.tensor([5, 1, 0, 4])
    ref.mu_rho_ref(torch.from_numpy(tr), torch.from_numpy(key), torch.from_numpy(msg),
                   torch.from_numpy(rnd), slots, reqs, torch.tensor([3]), mu, rr)
    for slot, req in ((2, 5), (0, 1), (3, 0)):
        m = hashlib.shake_256(bytes(tr) + bytes(msg[req])).digest(64)
        assert bytes(mu[slot].numpy()) == m
        assert bytes(rr[slot].numpy()) == hashlib.shake_256(bytes(key) + bytes(rnd[req]) + m) \
            .digest(64)
    assert not bool(mu[1].any())                  # past the count: no slot written


def test_codec_ops_equal_the_reference():
    rng = np.random.default_rng(6)
    r = torch.from_numpy(np.concatenate([[0, 1, Q - 1, Q - 2, 261888, 261889, 523776, 4096,
                                          4097], rng.integers(0, Q, 3000)]))
    hi, lo = codec.decompose(r)
    assert hi.tolist() == [R.decompose(int(v))[0] for v in r]
    assert lo.tolist() == [R.decompose(int(v))[1] for v in r]
    assert [tuple(map(int, p)) for p in zip(*codec.power2round(r))] == \
        [R.power2round(int(v)) for v in r]
    for bits in (4, 10, 13, 20):
        v = torch.from_numpy(rng.integers(0, 1 << bits, (2, 256)))
        packed = codec.pack_bits(v, bits)
        assert bytes(packed[1].numpy()) == R.simple_bit_pack(v[1].tolist(), bits)
        assert torch.equal(codec.unpack_bits(packed, bits), v)


# ------------------------------------------------------- the scheme

def test_keygen_equals_the_reference(keys):
    xi, pk, sk = keys
    assert pk.shape == (2, mldsa.PK_BYTES) and sk.shape == (2, mldsa.SK_BYTES)
    for i in range(2):
        assert (bytes(pk[i]), bytes(sk[i])) == R.MlDsa65.keygen(bytes(xi[i]))


def test_sign_batch_equals_the_reference_and_verifies(keys):
    """sign_batch under each key byte for byte with the reference's
    Sign_internal, the same iteration counts;
    the reference's Verify accepts each signature and rejects it with a
    byte flipped in c-tilde, z or the hint."""
    _, pk, sk = keys
    msg, rnd = _requests(7, 5, m=40)
    ref_ = R.MlDsa65()
    for k in range(2):
        sig, iters = mldsa.sign_batch(sk[k], msg, rnd, device="cpu")
        for i in range(5):
            want, n = ref_.sign(bytes(sk[k]), bytes(msg[i]), bytes(rnd[i]))
            assert bytes(sig[i]) == want and int(iters[i]) == n
            assert R.MlDsa65().verify(bytes(pk[k]), bytes(msg[i]), bytes(sig[i]))
        for at in (3, 48 + 1000, R.SIG_BYTES - 1):
            bad = bytearray(sig[0])
            bad[at] ^= 1
            assert not R.MlDsa65().verify(bytes(pk[k]), bytes(msg[0]), bytes(bad)), at


def test_stream_of_4_slots_over_16_requests(keys):
    """Refills, an idle drain and the output ring's places: every request
    signed once, at ring place = its completion rank; slot-iterations equal
    the iterations needed (no slot runs past its accept); after the drain
    the slots are idle and more rounds change nothing."""
    _, _, sk = keys
    msg, rnd = _requests(8, 16)
    s = mldsa.SignStream(torch.from_numpy(sk[0]), torch.from_numpy(msg),
                         torch.from_numpy(rnd), 4)
    assert s.ids.tolist() == [0, 1, 2, 3] and s.active.all()
    done = []
    while True:
        before = s.counters()["signatures"]
        s.advance()
        now = s.counters()
        done.append(now["signatures"] - before)
        if now["signatures"] == 16:
            break
        assert now["refills"] == min(16, 4 + now["signatures"])
    assert not s.active.any() or s.counters()["refills"] == 16
    ids, sigs, iters = (t.clone() for t in s.results())
    c = s.counters()
    s.advance(3)
    assert all(torch.equal(a, b) for a, b in zip((ids, sigs, iters), s.results()))
    assert s.counters()["signatures"] == 16 and not s.active.any()
    assert sorted(ids.tolist()) == list(range(16))
    assert c["slot_iterations"] == c["row_iterations"] == int(iters.sum())
    assert c["rounds"] == len(done) and max(done) <= 4
    ref_ = R.MlDsa65()
    for place in range(16):
        i = int(ids[place])
        want, n = ref_.sign(bytes(sk[0]), bytes(msg[i]), bytes(rnd[i]))
        assert bytes(sigs[place].numpy()) == want and int(iters[place]) == n


def test_cycled_stream_wraps_its_ring(keys):
    """A backlog that never empties (request r signs msgs[r % P]) and a ring
    of 3: the newest 3 completions stay, each a signature of its request."""
    _, _, sk = keys
    msg, rnd = _requests(9, 5)
    s = mldsa.SignStream(torch.from_numpy(sk[1]), torch.from_numpy(msg),
                         torch.from_numpy(rnd), 2, cycle=True, ring=3)
    while s.counters()["signatures"] < 5:
        s.advance()
    ids, sigs, iters = s.results()
    n = s.counters()["signatures"]
    assert int(s.out_count) == n and bool(s.active.all())
    assert sorted(ids.tolist()) == sorted(set(ids.tolist())) and min(ids.tolist()) >= 0
    ref_ = R.MlDsa65()
    for place in range(3):
        r = int(ids[place]) % 5
        want, k = ref_.sign(bytes(sk[1]), bytes(msg[r]), bytes(rnd[r]))
        assert bytes(sigs[place].numpy()) == want and int(iters[place]) == k


# --------------------------------------------------- no read-back, obs

READBACKS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__index__")


@pytest.mark.parametrize("slots", [1, 6])
def test_a_round_reads_nothing_back(monkeypatch, slots):
    """Rounds on ``meta`` tensors (every wrapper's shapes-only branch, as
    the card's) with every tensor read-back made to raise: the glue
    between the kernels reads nothing back, and a round launches the same
    kernels at 1 and 6 slots (no loop over rows)."""
    def refuse(*a, **k):
        raise AssertionError("a read-back inside a round")
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(f"{name} loaded"))
    msg = torch.zeros((8, 132), dtype=torch.uint8, device="meta")
    rnd = torch.zeros((8, 32), dtype=torch.uint8, device="meta")
    s = mldsa.SignStream(torch.zeros(mldsa.SK_BYTES, dtype=torch.uint8, device="meta"),
                         msg, rnd, slots, cycle=True, ring=16)
    for name in READBACKS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with op_cost.OpCounter() as c:
        s.advance(2)
    monkeypatch.undo()
    assert c.kernels == {"keccak_expand_mask": 2, "keccak_sample_in_ball": 2,
                         "keccak_hash": 2, "keccak_mu_rho": 2, "mldsa_w1_encode": 2,
                         "mldsa_check": 2, "mldsa_emit": 2, "ntt_fwd_banks": 4,
                         "ntt_inv_banks": 4, "dyadic_inner_banks": 4}


def test_spans_and_counters():
    """The mldsa.* spans (keygen; sign with its five children) and counters
    (rounds, slot-iterations, signatures, row-iterations, Keccak
    permutations from the shapes and the refills), and ops.* spans of the
    new entry points."""
    xi = np.random.default_rng(10).integers(0, 256, (1, 32), dtype=np.uint8)
    msg, rnd = _requests(11, 3)
    obs.enable()
    obs.clear()
    metrics.reset()
    try:
        _, sk = mldsa.keygen_batch(xi, device="cpu")
        s = mldsa.SignStream(torch.from_numpy(sk[0]), torch.from_numpy(msg),
                             torch.from_numpy(rnd), 2)
        s.advance(2)
        c = s.counters()
        names = {e["name"] for e in obs.events()}
        snap = metrics.snapshot()["counters"]
    finally:
        obs.disable()
        obs.clear()
    assert {"mldsa.keygen", "mldsa.sign", "mldsa.hash", "mldsa.sample", "mldsa.ring",
            "mldsa.check", "mldsa.refill"} <= names
    assert {"ops.keccak_expand_mask", "ops.keccak_sample_in_ball", "ops.keccak_rej_ntt_poly",
            "ops.keccak_rej_bounded", "ops.keccak_mu_rho", "ops.mldsa_w1_encode",
            "ops.mldsa_check", "ops.mldsa_emit"} <= names
    assert snap["mldsa.rounds"] == 2
    for name in ("slot_iterations", "signatures", "row_iterations"):
        assert snap[f"mldsa.{name}"] == c[name]
    assert c["slot_iterations"] == 4 and c["refills"] == 2 + c["signatures"]
    assert snap["mldsa.keccak_perms"] == (mldsa.KEYGEN_PERMS + 2 * 2 * mldsa.ROUND_PERMS
                                          + c["refills"] * mldsa.refill_perms(132))
    assert mldsa.ROUND_PERMS == 33 and mldsa.refill_perms(132) == 3
