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
from repro_torch.convert import from_reference, tensor_to_u32, u32_to_tensor
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
