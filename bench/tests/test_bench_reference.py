"""The plain reference against the port's CPU path on the same inputs:
multiply + relinearize, rescale, rotate, conjugate and a BSGS matvec at
n = 1024 (bit-reversed NTT words) and at n = 8192 (natural order, the
four-step layout of the timed 2^14 ring); the NTT-128 reference against
a brute-force O(n^2) transform and the port's ``ops.ntt``.  Tests may
import the port; the reference may not."""
import numpy as np
import pytest
import torch

from reference.ckks import CkksReference, KeySpec, chain, galois_element, matvec_key_amounts
from reference.modring import Arith
from reference.ntt128 import CyclicNtt, brute_force

from repro_torch.core.params import make_ntt_params
from repro_torch.fhe import linalg
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import Ciphertext
from repro_torch.fhe.rns import RnsPoly
from repro_torch.kernels import ops


def residues(basis, n, gen, count=2):
    q = torch.tensor(basis)[:, None]
    return [torch.randint(0, 2**62, (len(basis), n), generator=gen) % q for _ in range(count)]


def as_ct(c0, c1, basis, scale=2.0**28):
    return Ciphertext(RnsPoly(c0.int(), basis, True), RnsPoly(c1.int(), basis, True), scale)


def same(ct, want, basis):
    q = torch.tensor(basis)[:, None]
    return (ct.primes == tuple(basis)
            and all(torch.equal(h.data.long() % q, w) for h, w in zip((ct.c0, ct.c1), want)))


@pytest.fixture(scope="module", params=[(1024, 3), (8192, 1)], ids=["n1024", "n8192"])
def pair(request):
    """A port context and the reference replaying its key draws."""
    n, levels = request.param
    seed = 2**40 + 17
    ctx = CkksContext(n=n, levels=levels, seed=seed, device="cpu")
    P, qs = chain(n, levels)
    assert (P, qs) == (ctx.special, ctx.qs)
    W = np.random.default_rng(5).uniform(-1, 1, (4, 4)) / 8
    gs = sorted({galois_element(n, r) for r in (1, -2)} | {galois_element(n, None)}
                | {galois_element(n, r) for r in matvec_key_amounts(4, W)})
    order = [KeySpec(None, qs)] + [KeySpec(g, qs) for g in gs] + [KeySpec(None, qs[:-1])]
    plan = ctx.plan()
    for spec in order:
        plan.relin_key(spec.basis) if spec.g is None else plan.galois_key(spec.g, spec.basis)
    ref = CkksReference(n=n, levels=levels, seed=seed, key_order=order)
    return ctx, ref, W


def test_multiply_rescale_rotate_conjugate(pair):
    ctx, ref, _ = pair
    plan, qs, n = ctx.plan(), ctx.qs, ctx.n
    gen = torch.Generator().manual_seed(1)
    a0, a1, b0, b1 = residues(qs, n, gen, 4)
    A, B = as_ct(a0, a1, qs), as_ct(b0, b1, qs)
    assert same(plan.multiply(A, B), ref.multiply(a0, a1, b0, b1, qs), qs)
    assert same(plan.rescale(A), ref.rescale(a0, a1, qs), qs[:-1])
    assert same(plan.rotate(A, -2), ref.rotate(a0, a1, qs, galois_element(n, -2)), qs)
    assert same(plan.conjugate(A), ref.rotate(a0, a1, qs, galois_element(n, None)), qs)
    # a mixed-amount batch stacks one key per ciphertext
    out = plan.rotate_many([A, B], [1, -2])
    assert same(out[0], ref.rotate(a0, a1, qs, galois_element(n, 1)), qs)
    assert same(out[1], ref.rotate(b0, b1, qs, galois_element(n, -2)), qs)
    # one level down: relinearization at the lower basis
    low = qs[:-1]
    c0, c1, d0, d1 = residues(low, n, gen, 4)
    got = plan.multiply(as_ct(c0, c1, low), as_ct(d0, d1, low))
    assert same(got, ref.multiply(c0, c1, d0, d1, low), low)


def test_matvec(pair):
    ctx, ref, W = pair
    qs, n = ctx.qs, ctx.n
    gen = torch.Generator().manual_seed(2)
    x0, x1 = residues(qs, n, gen)
    M = linalg.PtMatrix.encode(ctx, W)
    got = linalg.matvec(ctx.plan(), M, as_ct(x0, x1, qs))
    assert same(got, ref.matvec(W, ctx.scale, x0, x1, qs), qs)


def test_control_breaks_exactness(pair):
    """The float64 reference differs from the exact one on most words."""
    ctx, ref, _ = pair
    qs, n = ctx.qs, ctx.n
    gen = torch.Generator().manual_seed(3)
    a0, a1 = residues(qs, n, gen)
    low = CkksReference(n=n, levels=len(qs) - 1, seed=2**40 + 17,
                        key_order=list(ref.keys), arith=Arith(exact=False))
    exact = ref.rescale(a0, a1, qs)[0]
    assert (low.rescale(a0, a1, qs)[0] != exact).float().mean() > 0.5


def test_ntt128_reference():
    p = make_ntt_params(128)
    rng = np.random.default_rng(3)
    x = rng.integers(0, p.q, (64, 128)).astype(np.int64)
    want = CyclicNtt(p.q, 128)(torch.from_numpy(x))
    for row in (0, 37):
        assert want[row].tolist() == brute_force(x[row], p.q, 128)
    port = ops.ntt(torch.from_numpy(x.astype(np.int32)), p, negacyclic=False)
    assert torch.equal(port.long(), want)
    low = CyclicNtt(p.q, 128, arith=Arith(exact=False))(torch.from_numpy(x))
    assert (low != want).float().mean() > 0.5
