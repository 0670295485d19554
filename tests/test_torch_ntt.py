"""The port's single-prime path — ``core/ntt.py``, the single-prime
``ops.ntt/intt/dyadic_mul/dyadic_mac`` (the paper's NTT-128 unit and its
Barrett MM/MA), Montgomery, and the four-step entry points of
``core/fourstep.py`` — against the JAX reference on the CPU: the
reference's plain path (``use_pallas=False``) over n in {16, ..., 1024},
its Pallas kernels in interpret mode at a few points, and exact numpy
oracles.  Integer outputs must be bit-identical, lazy [0, 2q)
representatives included."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypcompat import given, settings, st

from repro.core import fourstep as RF
from repro.core import modmath as RM
from repro.core import ntt as RN
from repro.core import params as RP
from repro.kernels import ops as RO

from repro_torch import kernels as K
from repro_torch.convert import tensor_to_u32, u32_to_tensor
from repro_torch.core import fourstep as TF
from repro_torch.core import modmath as TM
from repro_torch.core import ntt as TN
from repro_torch.core import params as TP
from repro_torch.kernels import ops as TO

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

NS = [16, 64, 128, 256, 1024]


def _params(n):
    return RP.make_ntt_params(n), TP.make_ntt_params(n)


def _rand(seed, q, shape, band=1):
    return np.random.default_rng(seed).integers(0, band * q, size=shape,
                                                dtype=np.uint32)


def _t(a):
    return u32_to_tensor(a, "cpu")


def _same(ref_out, port_out):
    return np.array_equal(np.asarray(ref_out), tensor_to_u32(port_out))


# ------------------------------------------------------------- core/ntt

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("reduce_out", [False, True])
def test_cg_ntt_and_intt_match_reference(n, lazy, reduce_out):
    rp, tp = _params(n)
    x = _rand(n, rp.q, (5, n))
    xin = _rand(n + 1, rp.q, (5, n), band=2 if lazy else 1)
    r = RN.cg_ntt(jnp.asarray(x), jnp.asarray(rp.tw), jnp.asarray(rp.twp), rp.q,
                  lazy=lazy, reduce_out=reduce_out)
    p = TN.cg_ntt(_t(x), _t(tp.tw), _t(tp.twp), tp.q, lazy=lazy,
                  reduce_out=reduce_out)
    assert _same(r, p)
    if lazy and not reduce_out:          # the raw band reaches past q
        assert tensor_to_u32(p).max() >= rp.q
    for apply_ninv in (False, True):
        r = RN.cg_intt(jnp.asarray(xin), jnp.asarray(rp.itw), jnp.asarray(rp.itwp),
                       rp.ninv, rp.ninv_p, rp.q, apply_ninv=apply_ninv,
                       lazy=lazy, reduce_out=reduce_out)
        p = TN.cg_intt(_t(xin), _t(tp.itw), _t(tp.itwp), tp.ninv, tp.ninv_p,
                       tp.q, apply_ninv=apply_ninv, lazy=lazy,
                       reduce_out=reduce_out)
        assert _same(r, p), apply_ninv


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_transforms_match_reference(n, negacyclic, lazy):
    rp, tp = _params(n)
    x = _rand(2 * n, rp.q, (3, n))
    fwd = (RN.ntt_negacyclic, TN.ntt_negacyclic) if negacyclic else \
        (RN.ntt_cyclic, TN.ntt_cyclic)
    inv = (RN.intt_negacyclic, TN.intt_negacyclic) if negacyclic else \
        (RN.intt_cyclic, TN.intt_cyclic)
    y = fwd[1](_t(x), tp, lazy=lazy)
    assert _same(fwd[0](jnp.asarray(x), rp, lazy=lazy), y)
    assert _same(inv[0](jnp.asarray(x), rp, lazy=lazy), inv[1](_t(x), tp, lazy=lazy))
    assert torch.equal(inv[1](y, tp, lazy=lazy), _t(x))


@pytest.mark.parametrize("n", NS)
def test_numpy_oracles_match_reference(n):
    rp, tp = _params(n)
    a = _rand(3 * n, rp.q, (4, n))
    assert np.array_equal(RN.brute_ntt_np(a, rp.omega, rp.q),
                          TN.brute_ntt_np(a, tp.omega, tp.q))
    got = TN.brute_ntt_bitrev_np(a, tp.omega, tp.q)
    assert got.dtype == np.uint32
    assert np.array_equal(RN.brute_ntt_bitrev_np(a, rp.omega, rp.q), got)
    # the CG network's output is the brute oracle's, bit-reversed
    assert np.array_equal(tensor_to_u32(TN.ntt_cyclic(_t(a), tp)), got)
    conv = TN.negacyclic_convolve_np(a[0], a[1], tp.q)
    assert conv.dtype == np.uint32
    assert np.array_equal(RN.negacyclic_convolve_np(a[0], a[1], rp.q), conv)


def test_oracles_at_the_top_of_the_word():
    """Operands near 2^32 (the limb split covers the whole word)."""
    q = TP.make_ntt_params(64).q
    a = np.full(64, 2**32 - 1, dtype=np.uint32)
    b = np.arange(64, dtype=np.uint32) + np.uint32(q - 64)
    assert np.array_equal(TN.negacyclic_convolve_np(a, b, q),
                          RN.negacyclic_convolve_np(a, b, q))


# ---------------------------------------------------- single-prime ops

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_ops_ntt_intt_match_reference_plain(n, negacyclic, lazy):
    rp, tp = _params(n)
    x = _rand(4 * n, rp.q, (9, n))
    kw = dict(negacyclic=negacyclic, lazy=lazy)
    K.reset_counts()
    y = TO.ntt(_t(x), tp, **kw)
    assert _same(RO.ntt(jnp.asarray(x), rp, use_pallas=False, **kw), y)
    back = TO.intt(y, tp, **kw)
    assert _same(RO.intt(jnp.asarray(tensor_to_u32(y)), rp, use_pallas=False, **kw),
                 back)
    assert torch.equal(back, _t(x))
    c = K.snapshot()
    assert c["ntt_fwd"] == c["ntt_inv"] == {"launches": 0, "plain_calls": 1}


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("lazy", [False, True])
def test_ops_match_reference_pallas_interpret(n, lazy):
    """The reference's own single-prime Pallas kernels (interpret mode),
    at an odd batch."""
    rp, tp = _params(n)
    x, b, acc = (_rand(5 * n + i, rp.q, (13, n)) for i in range(3))
    for neg in (False, True):
        kw = dict(negacyclic=neg, lazy=lazy)
        assert _same(RO.ntt(jnp.asarray(x), rp, use_pallas=True, **kw),
                     TO.ntt(_t(x), tp, **kw))
        assert _same(RO.intt(jnp.asarray(x), rp, use_pallas=True, **kw),
                     TO.intt(_t(x), tp, **kw))
    assert _same(RO.dyadic_mul(jnp.asarray(x), jnp.asarray(b), rp, use_pallas=True,
                               lazy=lazy),
                 TO.dyadic_mul(_t(x), _t(b), tp, lazy=lazy))
    assert _same(RO.dyadic_mac(jnp.asarray(acc), jnp.asarray(x), jnp.asarray(b), rp,
                               use_pallas=True, lazy=lazy),
                 TO.dyadic_mac(_t(acc), _t(x), _t(b), tp, lazy=lazy))


def test_ops_leading_dims():
    rp, tp = _params(128)
    x = _rand(7, rp.q, (3, 5, 128))
    y = TO.ntt(_t(x), tp)
    assert y.shape == (3, 5, 128)
    assert _same(RO.ntt(jnp.asarray(x), rp, use_pallas=False), y)
    assert _same(RO.intt(jnp.asarray(x), rp, use_pallas=False), TO.intt(_t(x), tp))
    assert _same(RO.dyadic_mul(jnp.asarray(x), jnp.asarray(x), rp, use_pallas=False),
                 TO.dyadic_mul(_t(x), _t(x), tp))


def test_ops_refuse_rows_of_another_ring():
    _, tp = _params(128)
    x = torch.zeros((2, 256), dtype=torch.int32)
    for fn in (TO.ntt, TO.intt):
        with pytest.raises(ValueError, match="n=128"):
            fn(x, tp)


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("batch", [1, 8, 9])
@pytest.mark.parametrize("lazy", [False, True])
def test_dyadic_match_reference_and_u64(n, batch, lazy):
    rp, tp = _params(n)
    acc, a, b = (_rand(n + batch + i, rp.q, (batch, n)) for i in range(3))
    K.reset_counts()
    mul = TO.dyadic_mul(_t(a), _t(b), tp, lazy=lazy)
    mac = TO.dyadic_mac(_t(acc), _t(a), _t(b), tp, lazy=lazy)
    assert _same(RO.dyadic_mul(jnp.asarray(a), jnp.asarray(b), rp, use_pallas=False,
                               lazy=lazy), mul)
    assert _same(RO.dyadic_mac(jnp.asarray(acc), jnp.asarray(a), jnp.asarray(b), rp,
                               use_pallas=False, lazy=lazy), mac)
    prod = a.astype(np.uint64) * b % np.uint64(tp.q)
    assert np.array_equal(tensor_to_u32(mul), prod.astype(np.uint32))
    assert np.array_equal(tensor_to_u32(mac),
                          ((acc + prod) % np.uint64(tp.q)).astype(np.uint32))
    c = K.snapshot()
    assert c["dyadic_mul"] == c["dyadic_mac"] == {"launches": 0, "plain_calls": 1}


# ------------------------------------------------------------ Montgomery

Q = TP.make_ntt_params(1024).q
QINV_NEG, R2 = TM.montgomery_precompute(Q)


def test_montgomery_precompute_matches_reference():
    assert (QINV_NEG, R2) == RM.montgomery_precompute(Q)


def test_montmul_band_edges_match_reference():
    edges = np.array([0, 1, 2, Q // 2, Q - 2, Q - 1], dtype=np.uint32)
    a, b = (v.ravel() for v in np.meshgrid(edges, edges))
    r = RM.montmul(jnp.asarray(a), jnp.asarray(b), jnp.uint32(Q), jnp.uint32(QINV_NEG))
    assert _same(r, TM.montmul(TM.u32(_t(a)), TM.u32(_t(b)), Q, QINV_NEG).int())
    m = TM.mulmod_montgomery(TM.u32(_t(a)), TM.u32(_t(b)), Q, QINV_NEG, R2)
    assert np.array_equal(tensor_to_u32(m.int()), TM.mulmod_np(a, b, Q))


@settings(max_examples=100, deadline=None, database=None)
@given(a=st.integers(0, Q - 1), b=st.integers(0, Q - 1))
def test_montgomery_property(a, b):
    ta, tb = torch.tensor([a]), torch.tensor([b])
    r = RM.montmul(jnp.asarray([a], jnp.uint32), jnp.asarray([b], jnp.uint32),
                   jnp.uint32(Q), jnp.uint32(QINV_NEG))
    assert int(np.asarray(r)[0]) == int(TM.montmul(ta, tb, Q, QINV_NEG)[0])
    assert int(TM.mulmod_montgomery(ta, tb, Q, QINV_NEG, R2)[0]) == a * b % Q


# ------------------------------------------------------------- four-step

N1 = N2 = 32


def test_fourstep_matches_reference_and_natural_order():
    rf, tf = RF.make_fourstep_params(N1, N2), TF.make_fourstep_params(N1, N2)
    rp = RP.make_ntt_params(rf.n, q=rf.q)
    tp = TP.make_ntt_params(tf.n, q=tf.q)
    a = _rand(11, rf.q, (2, rf.n))
    nat = TF.ntt_natural(_t(a), tp)
    assert _same(RF.ntt_natural(jnp.asarray(a), rp), nat)
    for neg in (False, True):
        A = TF.fourstep_ntt(_t(a), tf, negacyclic=neg)
        assert _same(RF.fourstep_ntt(jnp.asarray(a), rf, negacyclic=neg,
                                     use_pallas=False), A)
        back = TF.fourstep_intt(A, tf, negacyclic=neg)
        assert _same(RF.fourstep_intt(jnp.asarray(tensor_to_u32(A)), rf,
                                      negacyclic=neg, use_pallas=False), back)
        assert torch.equal(back, _t(a))
    # the cyclic four-step output is the natural-order transform
    assert torch.equal(TF.fourstep_ntt(_t(a), tf), nat)


@pytest.mark.parametrize("n1,n2", [(32, 32), (128, 128), (64, 256)])
def test_fourstep_schedule_matches_reference(n1, n2):
    assert TF.fourstep_schedule(n1, n2) == RF.fourstep_schedule(n1, n2)


# ---------------------------------------------------------- the slice

def test_slice_ntt128_batch_and_product():
    """2,000 NTT-128s through ``ops.ntt`` (the Table III transform,
    cyclic) against the reference's ``ntt_cyclic`` and 64 of them against
    the brute-force oracle; one n = 256 negacyclic product through
    ntt -> dyadic_mul -> intt against the schoolbook convolution."""
    rp, tp = _params(128)
    x = _rand(128, rp.q, (2000, 128))
    y = TO.ntt(_t(x), tp, negacyclic=False)
    assert _same(RN.ntt_cyclic(jnp.asarray(x), rp), y)
    assert np.array_equal(tensor_to_u32(y[:64]),
                          RN.brute_ntt_bitrev_np(x[:64], rp.omega, rp.q))
    rp, tp = _params(256)
    a, b = _rand(256, rp.q, (2, 256))
    c = TO.intt(TO.dyadic_mul(TO.ntt(_t(a), tp), TO.ntt(_t(b), tp), tp), tp)
    assert np.array_equal(tensor_to_u32(c), RN.negacyclic_convolve_np(a, b, rp.q))
