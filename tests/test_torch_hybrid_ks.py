"""Hybrid key switching in the port (``CkksContext(dnum=...)``: digits of
alpha primes, a special modulus of K = alpha primes) against the
benchmark's plain reference ``bench/reference/ckks_hybrid.py`` on the
CPU, word for word.

At n = 2^10 (bit-reversed rows) and 2^13 (four-step, natural rows), L + 1
= 5 and dnum = 2 (alpha = K = 3; digits of 3 + 2 primes, and 3 + 1 one
level down): rotate, conjugate, mixed ``rotate_many``, ``rotate_hoisted``,
the relinearized multiply, and a rescale followed by a rotation.  Also:
the fast base conversion's plain path (``ops.base_conv_banks``) against a
Python-int oracle of the formula on edge residues, decryption within the
one-prime-digit path's tolerance, ``dnum=None`` and ``dnum = L + 1``
giving the words of the JAX reference's context, the plan's counts, and
the refusals (an out-of-range dnum, a "k"-sharded mesh).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.fhe.ckks import CkksContext as RefContext

from repro_torch.convert import from_reference, tensor_to_u32
from repro_torch.core.params import gen_ntt_primes
from repro_torch.fhe import batched as FB
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import Ciphertext, EvalPlan
from repro_torch.fhe.rns import RnsPoly
from repro_torch.kernels import ops
from repro_torch.mesh import make_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))
from reference.ckks import KeySpec, galois_element  # noqa: E402
from reference.ckks_hybrid import HybridReference, hybrid_chain  # noqa: E402

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

LEVELS, DNUM, SEED = 4, 2, 11
AMOUNTS = (1, -3, 5)
B = 3                                       # ciphertexts a batched case


class Deployment:
    """A hybrid port context and the reference, keys drawn in one
    documented order, and a pool of uniform-residue ciphertexts at the
    full chain and one level down."""

    def __init__(self, n: int):
        self.n = n
        self.ctx = CkksContext(n=n, levels=LEVELS, seed=SEED, device="cpu", dnum=DNUM)
        full = self.ctx.qs
        self.bases = (full, full[:-1])
        gs = sorted({galois_element(n, r) for r in AMOUNTS} | {galois_element(n, None)})
        self.order = [KeySpec(None, full)] + [KeySpec(g, full) for g in gs] + [
            KeySpec(galois_element(n, 1), full[:-1])]
        plan = self.plan = self.ctx.plan()
        for spec in self.order:
            if spec.g is None:
                plan.relin_key(spec.basis)
            else:
                plan.galois_key(spec.g, spec.basis)
        self.ref = HybridReference(n=n, levels=LEVELS, dnum=DNUM, seed=SEED,
                                   key_order=self.order)
        rng = np.random.default_rng(n)
        self.words = {basis: [np.stack([rng.integers(0, q, (2, n)) for q in basis], axis=1)
                              for _ in range(B)] for basis in self.bases}

    def cts(self, basis):
        return [Ciphertext(*(RnsPoly(from_reference(w[h].astype(np.uint32), "cpu"), basis, True)
                             for h in (0, 1)), self.ctx.scale) for w in self.words[basis]]

    def ref_words(self, basis, i):
        w = torch.as_tensor(self.words[basis][i], dtype=torch.int64)
        return w[0], w[1]


@pytest.fixture(scope="module", params=[1 << 10, 1 << 13], ids=["n1024", "n8192"])
def dep(request):
    return Deployment(request.param)


def _same(ct, want0, want1, basis):
    q = torch.tensor(basis, dtype=torch.int64)[:, None]
    assert ct.primes == tuple(basis)
    for got, want in ((ct.c0, want0), (ct.c1, want1)):
        g = torch.as_tensor(tensor_to_u32(got.data).astype(np.int64))
        assert torch.equal(g % q, want % q)


def test_chain_and_digits_match_the_reference(dep):
    alpha, Ps, qs = hybrid_chain(dep.n, LEVELS, DNUM)
    assert (dep.ctx.alpha, dep.ctx.specials, dep.ctx.qs) == (alpha, Ps, qs) == (
        3, dep.ref.Ps, dep.ref.qs)
    assert dep.ctx.special is None
    assert [len(d) for d in dep.ctx.digits(qs)] == [3, 2]
    assert [len(d) for d in dep.ctx.digits(qs[:-1])] == [3, 1]
    assert tuple(gen_ntt_primes(LEVELS + 1 + alpha, dep.n)) == Ps + qs


def test_keys_equal_the_reference(dep):
    for spec in dep.order:
        eb, ea = (dep.plan.relin_key(spec.basis) if spec.g is None
                  else dep.plan.galois_key(spec.g, spec.basis))
        rb, ra = dep.ref.keys[spec]
        assert eb.shape == (math.ceil(len(spec.basis) / 3), len(spec.basis) + 3, dep.n)
        assert np.array_equal(tensor_to_u32(eb).astype(np.int64), rb.numpy())
        assert np.array_equal(tensor_to_u32(ea).astype(np.int64), ra.numpy())


@pytest.mark.parametrize("r", AMOUNTS)
def test_rotate(dep, r):
    basis = dep.bases[0]
    ct = dep.cts(basis)[0]
    got = dep.ctx.rotate(ct, r)
    _same(got, *dep.ref.rotate(*dep.ref_words(basis, 0), basis, galois_element(dep.n, r)),
          basis)


def test_conjugate(dep):
    basis = dep.bases[0]
    got = dep.ctx.conjugate(dep.cts(basis)[1])
    _same(got, *dep.ref.rotate(*dep.ref_words(basis, 1), basis, galois_element(dep.n, None)),
          basis)


def test_rotate_many_mixed(dep):
    basis = dep.bases[0]
    rs = [1, 5, -3]
    got = dep.ctx.rotate_many(dep.cts(basis), rs)
    for i, (ct, r) in enumerate(zip(got, rs)):
        _same(ct, *dep.ref.rotate(*dep.ref_words(basis, i), basis, galois_element(dep.n, r)),
              basis)


def test_rotate_hoisted(dep):
    """One mod-up, each automorphism applied to the converted digits: the
    reference's hoisted rotations (not ``rotate``'s words, which convert
    each rotated c1)."""
    basis = dep.bases[0]
    rs = [1, 5, 1, -3]
    got = dep.ctx.rotate_hoisted(dep.cts(basis)[2], rs)
    want = dep.ref.rotate_hoisted(*dep.ref_words(basis, 2), basis,
                                  [galois_element(dep.n, r) for r in rs])
    for ct, w in zip(got, want):
        _same(ct, *w, basis)


def test_multiply_relinearized(dep):
    basis = dep.bases[0]
    a, b = dep.cts(basis)[:2]
    got = dep.ctx.multiply_many([a, b], [b, b])
    pairs = ((0, 1), (1, 1))
    for ct, (i, j) in zip(got, pairs):
        _same(ct, *dep.ref.multiply(*dep.ref_words(basis, i), *dep.ref_words(basis, j), basis),
              basis)
    _same(dep.ctx.multiply(a, b), *dep.ref.multiply(*dep.ref_words(basis, 0),
                                                    *dep.ref_words(basis, 1), basis), basis)


def test_rescale_then_rotate_a_partial_digit(dep):
    """A rescale keeps one prime (the centred floor by q_L); the rotation
    one level down switches with digits of 3 + 1 primes."""
    basis = dep.bases[0]
    ct = dep.ctx.rescale(dep.cts(basis)[0])
    r0, r1 = dep.ref.rescale(*dep.ref_words(basis, 0), basis)
    _same(ct, r0, r1, basis[:-1])
    got = dep.ctx.rotate(ct, 1)
    _same(got, *dep.ref.rotate(r0, r1, basis[:-1], galois_element(dep.n, 1)), basis[:-1])


def test_plan_counts(dep):
    """The plan counts a hybrid program as it counts any other."""
    plan = dep.plan
    plan.reset_stats()
    basis = dep.bases[0]
    dep.ctx.rotate_many(dep.cts(basis), [1, 1, 5])          # 3 decompositions
    dep.ctx.rotate_hoisted(dep.cts(basis)[0], [1, 5])       # 1
    dep.ctx.rotate(dep.ctx.rescale(dep.cts(basis)[0]), 1)   # 1 (digits of 3 + 1 primes)
    assert plan.stats == {"dispatches": 4, "key_switches": 6, "decomposes": 5}


# ------------------------------------------------- the conversion alone

def _edges(q):
    return [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]


@pytest.mark.parametrize("alpha", [3, 6, 9], ids=lambda a: f"alpha{a}")
def test_base_conv_equals_the_python_int_formula(alpha):
    """Digits of alpha primes onto the whole basis + K specials (the
    tables pad to 4, 8 and 16 slots), and the K specials onto the chain,
    on rows that start with every source prime's edge residues."""
    n, chain = 64, 2 * alpha - 1
    primes = gen_ntt_primes(chain + alpha, n)
    Ps, qs = tuple(primes[:alpha]), tuple(primes[alpha:])
    rng = np.random.default_rng(alpha)
    for srcs, groups, dst in (
            (qs, FB.key_digits(qs, alpha), qs + Ps),
            (Ps, [Ps], qs)):
        x = np.stack([rng.integers(0, q, n) for q in srcs])
        for i, q in enumerate(srcs):
            x[i, :5] = _edges(q)
            x[i, 5 + i % 3: 10 + i % 3] = _edges(q)
        lo, table = 0, []
        for g in groups:
            table.append([(lo + i, q) for i, q in enumerate(g)])
            lo += len(g)
        conv = from_reference(FB.conv_table_np(table, dst), "cpu")
        got = tensor_to_u32(ops.base_conv_banks(
            from_reference(x.astype(np.uint32), "cpu")[:, None], conv)[:, :, 0])
        assert got.shape == (len(dst), len(groups), n)
        for gi, g in enumerate(table):
            Q = math.prod(q for _, q in g)
            for t, p in enumerate(dst):
                for c in range(n):
                    if any(p == q for _, q in g):
                        want = int(x[[row for row, q in g if q == p][0], c])
                    else:
                        want = sum(int(x[row, c]) * pow(Q // q, -1, q) % q * (Q // q)
                                   for row, q in g) % p
                    assert int(got[t, gi, c]) == want, (gi, t, c)


def test_conv_table_refuses_too_wide_a_digit():
    primes = gen_ntt_primes(17, 64)
    with pytest.raises(ValueError, match="at most 16"):
        FB.conv_table_np([list(enumerate(primes))], primes[:1])


# ------------------------------------------------ decryption, old words

def test_hybrid_ciphertexts_decrypt_within_tolerance():
    """Encryptions through the hybrid path decrypt to their slots within
    the tolerances the one-prime-digit path's tests use at 2^10."""
    ctx = CkksContext(n=1 << 10, levels=LEVELS, seed=3, device="cpu", dnum=DNUM)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
    ct = ctx.encrypt(ctx.encode(z))
    for r in (1, 7):
        np.testing.assert_allclose(ctx.decrypt_decode(ctx.rotate(ct, r)), np.roll(z, -r),
                                   atol=1e-3)
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.conjugate(ct)), np.conj(z), atol=1e-3)
    for got, r in zip(ctx.rotate_hoisted(ct, [2, 3]), [2, 3]):
        np.testing.assert_allclose(ctx.decrypt_decode(got), np.roll(z, -r), atol=1e-3)
    prod = ctx.rescale(ctx.multiply(ct, ct))
    np.testing.assert_allclose(ctx.decrypt_decode(prod), z * z, atol=1e-2)
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.rotate(prod, 1)), np.roll(z * z, -1),
                               atol=1e-2)


@pytest.mark.parametrize("dnum", [None, LEVELS + 1], ids=["none", "L+1"])
def test_one_prime_digits_give_the_old_words(dnum):
    """dnum=None and dnum = L + 1 are the one-prime-digit key switch: the
    JAX reference's context with the same seed gives the same words."""
    n = 64
    ref = RefContext(n=n, levels=LEVELS, seed=5)
    port = CkksContext(n=n, levels=LEVELS, seed=5, device="cpu", dnum=dnum)
    assert (port.alpha, port.specials, port.special, port.qs) == (
        1, (ref.special,), ref.special, tuple(ref.qs))
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, port.slots)
    rct, pct = ref.encrypt(ref.encode(z)), port.encrypt(port.encode(z))
    for op in (lambda c, x: c.rotate(x, 3), lambda c, x: c.conjugate(x),
               lambda c, x: c.rescale(c.multiply(x, x))):
        r, p = op(ref, rct), op(port, pct)
        for rh, ph in ((r.c0, p.c0), (r.c1, p.c1)):
            assert np.array_equal(np.asarray(rh.data), tensor_to_u32(ph.data))
    assert port.plan().stats == ref.plan().stats


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("dnum", [0, LEVELS + 2])
def test_dnum_out_of_range_is_refused(dnum):
    with pytest.raises(ValueError, match="dnum"):
        CkksContext(n=64, levels=LEVELS, seed=0, device="cpu", dnum=dnum)


def test_k_mesh_refuses_hybrid_key_switching():
    ctx = CkksContext(n=64, levels=LEVELS, seed=0, device="cpu", dnum=DNUM)
    with pytest.raises(NotImplementedError, match="dnum = 2"):
        EvalPlan(ctx, mesh=make_mesh(["cpu"] * 2, ("k",)))
    EvalPlan(ctx, mesh=make_mesh(["cpu"] * 2))               # the "b" axis is fine
