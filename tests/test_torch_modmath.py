"""The port's u32 modular arithmetic and host tables against the JAX
reference: bit-identical representatives on the band edges
{0, 1, q-1, q, q+1, 2q-1} plus random values, and every table array
(NTTParams, FourStepParams, TablePack, FourStepPack, scalar pack) equal
to the reference's uint32 array — also after ``convert.from_reference``
carries it across."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypcompat import given, settings, st

from repro.core import fourstep as r_fourstep
from repro.core import modmath as rm
from repro.core import params as r_params
from repro.fhe import batched as RB

from repro_torch.convert import from_reference, tensor_to_u32, u32_to_tensor
from repro_torch.core import fourstep as t_fourstep
from repro_torch.core import modmath as tm
from repro_torch.core import params as t_params
from repro_torch.fhe import batched as TB

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

PRIMES = r_params.gen_ntt_primes(3, 1024)
Q = PRIMES[0]
RNG = np.random.default_rng(2026)


def _t(a):
    """uint32 numpy -> int64 torch holding the u32 values."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def _pairs(q, lo_band, hi_band, size=4096):
    """All pairs over the band edges inside [0, hi_band*q), then random
    pairs in [0, lo_band*q) x [0, hi_band*q)."""
    edges = np.array([e for e in (0, 1, q - 1, q, q + 1, 2 * q - 1)
                      if e < hi_band * q], dtype=np.uint32)
    a = np.concatenate([np.repeat(edges, len(edges)),
                        RNG.integers(0, lo_band * q, size, dtype=np.uint32)])
    b = np.concatenate([np.tile(edges, len(edges)),
                        RNG.integers(0, hi_band * q, size, dtype=np.uint32)])
    return a, b


@pytest.mark.parametrize("q", PRIMES)
def test_add_sub_match_reference(q):
    a, b = _pairs(q, 1, 1)
    qa, qt = jnp.uint32(q), torch.tensor(q)
    assert np.array_equal(_np(tm.addmod(_t(a), _t(b), qt)),
                          np.asarray(rm.addmod(jnp.asarray(a), jnp.asarray(b), qa)))
    assert np.array_equal(_np(tm.submod(_t(a), _t(b), qt)),
                          np.asarray(rm.submod(jnp.asarray(a), jnp.asarray(b), qa)))
    assert np.array_equal(_np(tm.addmod(_t(a), _t(b), qt)), tm.addmod_np(a, b, q))
    assert np.array_equal(_np(tm.submod(_t(a), _t(b), qt)), tm.submod_np(a, b, q))


@pytest.mark.parametrize("q", PRIMES)
def test_lazy_add_sub_band_edges(q):
    a, b = _pairs(q, 2, 2)
    qa, qt = jnp.uint32(q), torch.tensor(q)
    ga = _np(tm.lazy_addmod(_t(a), _t(b), qt))
    gs = _np(tm.lazy_submod(_t(a), _t(b), qt))
    assert np.array_equal(ga, np.asarray(rm.lazy_addmod(jnp.asarray(a), jnp.asarray(b), qa)))
    assert np.array_equal(gs, np.asarray(rm.lazy_submod(jnp.asarray(a), jnp.asarray(b), qa)))
    assert np.array_equal(ga, tm.lazy_addmod_np(a, b, q))
    assert np.array_equal(gs, tm.lazy_submod_np(a, b, q))
    assert ga.max() < 2 * q and gs.max() < 2 * q


@pytest.mark.parametrize("q", PRIMES)
def test_shoup_band_edges_and_any_u32(q):
    """Shoup takes any u32 x (the lazy band and beyond): the eager and the
    lazy representative both match the reference's u32 datapath."""
    x, w = _pairs(q, 2, 1)
    x = np.concatenate([x, np.array([2**31 - 1, 2**32 - 1], dtype=np.uint32),
                        RNG.integers(0, 2**32, 1024, dtype=np.uint32)])
    w = np.concatenate([w, RNG.integers(0, q, 1026, dtype=np.uint32)])
    wp = np.array([tm.shoup_precompute(int(v), q) for v in w], dtype=np.uint32)
    assert np.array_equal(wp, np.array([rm.shoup_precompute(int(v), q) for v in w],
                                       dtype=np.uint32))
    qa, qt = jnp.uint32(q), torch.tensor(q)
    args_r = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(wp), qa)
    args_t = (_t(x), _t(w), _t(wp), qt)
    lazy = _np(tm.mulmod_shoup_lazy(*args_t))
    assert np.array_equal(lazy, np.asarray(rm.mulmod_shoup_lazy(*args_r)))
    assert np.array_equal(lazy, tm.mulmod_shoup_lazy_np(x, w, q))
    assert np.array_equal(_np(tm.mulmod_shoup(*args_t)),
                          np.asarray(rm.mulmod_shoup(*args_r)))
    assert np.array_equal(_np(tm.mulmod_shoup(*args_t)), tm.mulmod_np(x, w, q))


@pytest.mark.parametrize("q", PRIMES)
def test_barrett_band_edges(q):
    a, b = _pairs(q, 1, 1)
    mu = tm.barrett_precompute(q)
    assert mu == rm.barrett_precompute(q)
    args_r = (jnp.asarray(a), jnp.asarray(b), jnp.uint32(q), jnp.uint32(mu))
    args_t = (_t(a), _t(b), torch.tensor(q), torch.tensor(mu))
    lazy = _np(tm.mulmod_barrett_lazy(*args_t))
    assert np.array_equal(lazy, np.asarray(rm.mulmod_barrett_lazy(*args_r)))
    assert np.array_equal(lazy, tm.mulmod_barrett_lazy_np(a, b, q))
    assert np.array_equal(_np(tm.mulmod_barrett(*args_t)),
                          np.asarray(rm.mulmod_barrett(*args_r)))
    assert np.array_equal(_np(tm.mulmod_barrett(*args_t)), tm.mulmod_np(a, b, q))


def test_limb_products_match_numpy():
    a = RNG.integers(0, 2**32, 8192, dtype=np.uint32)
    b = RNG.integers(0, 2**32, 8192, dtype=np.uint32)
    assert np.array_equal(_np(tm.mulhi_u32(_t(a), _t(b))), tm.mulhi_np(a, b))
    want = (a.astype(np.uint64) * b.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    assert np.array_equal(_np(tm.mullo_u32(_t(a), _t(b))), want.astype(np.uint32))


@settings(max_examples=200, deadline=None, database=None)
@given(x=st.integers(0, 2**32 - 1), w=st.integers(0, Q - 1),
       a=st.integers(0, Q - 1))
def test_multipliers_property(x, w, a):
    wp = tm.shoup_precompute(w, Q)
    mu = tm.barrett_precompute(Q)
    q = torch.tensor(Q)
    got = int(tm.mulmod_shoup(torch.tensor(x), torch.tensor(w), torch.tensor(wp), q))
    assert got == (x * w) % Q
    lazy = int(tm.mulmod_barrett_lazy(torch.tensor(a), torch.tensor(w), q,
                                      torch.tensor(mu)))
    assert lazy == int(tm.mulmod_barrett_lazy_np(a, w, Q)) and lazy % Q == a * w % Q


def test_barrett_precompute_rejects_out_of_window():
    for q in (1 << 28, (1 << 30) + 1, 17):
        with pytest.raises(ValueError, match="Barrett range"):
            tm.barrett_precompute(q)


def test_params_helpers_match_reference():
    assert t_params.gen_ntt_primes(5, 2048) == r_params.gen_ntt_primes(5, 2048)
    for n in (16, 128, 1024):
        assert np.array_equal(t_params.bitrev_perm(n), r_params.bitrev_perm(n))
    for n in (1 << 10, 1 << 12, 1 << 13, 1 << 14):
        assert t_params.fourstep_split(n) == r_params.fourstep_split(n)


def _same_fields(a, b, names):
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype == np.uint32, name
            assert np.array_equal(va, vb), name
        else:
            assert va == vb, name


_NTT_FIELDS = ("n", "q", "omega", "psi", "tw", "twp", "itw", "itwp", "ninv",
               "ninv_p", "psi_pows", "psi_pows_p", "ipsi_ninv", "ipsi_ninv_p",
               "barrett_mu", "mont_qinv_neg", "mont_r2")


@pytest.mark.parametrize("n", [16, 128, 1024])
def test_ntt_params_equal_reference(n):
    for q in r_params.gen_ntt_primes(2, n):
        _same_fields(t_params.make_ntt_params(n, q=q),
                     r_params.make_ntt_params(n, q=q), _NTT_FIELDS)


@pytest.mark.parametrize("n1,n2", [(32, 32), (128, 128)])
def test_fourstep_params_equal_reference(n1, n2):
    q = r_params.gen_ntt_primes(1, n1 * n2)[0]
    a = t_fourstep.make_fourstep_params(n1, n2, q)
    b = r_fourstep.make_fourstep_params(n1, n2, q)
    _same_fields(a, b, ("n", "n1", "n2", "q", "tw_mat", "tw_mat_p", "itw_mat",
                        "itw_mat_p", "psi_mat", "psi_mat_p", "ipsi_mat",
                        "ipsi_mat_p"))
    _same_fields(a.p1, b.p1, _NTT_FIELDS)
    _same_fields(a.p2, b.p2, _NTT_FIELDS)


def _assert_tree_equal(ref, port, path=""):
    """Every leaf of a reference pack equal to the port's: uint32 numpy
    on the host side, int32 bit-pattern tensors on the device side."""
    assert set(ref) == set(port), path
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_tree_equal(ref[k], port[k], f"{path}/{k}")
            continue
        want = np.asarray(ref[k])
        got = port[k]
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.int32, f"{path}/{k}"
            got = tensor_to_u32(got)
        assert got.dtype == want.dtype == np.uint32, f"{path}/{k}"
        assert np.array_equal(got, want), f"{path}/{k}"


def test_table_pack_equal_reference():
    n = 1024
    primes = r_params.gen_ntt_primes(4, n)
    ref = RB.build_table_pack(primes, n)
    _assert_tree_equal(ref, TB.table_pack_np(tuple(primes), n))
    _assert_tree_equal(ref, TB.build_table_pack(primes, n, "cpu"))
    _assert_tree_equal(ref, from_reference(ref, "cpu"))


def test_scalar_and_fourstep_packs_equal_reference():
    n = 1 << 12
    primes = r_params.gen_ntt_primes(3, n)
    _assert_tree_equal(RB.build_scalar_pack(primes), TB.build_scalar_pack(primes, "cpu"))
    ref = RB.build_fourstep_pack(primes, n)
    _assert_tree_equal(ref, TB.fourstep_pack_np(tuple(primes), n))
    port = TB.build_fourstep_pack(primes, n, "cpu")
    _assert_tree_equal(ref, port)
    _assert_tree_equal(RB.slice_fourstep_pack(ref, slice(0, 2)),
                       TB.slice_fourstep_pack(port, slice(0, 2)))


def test_bit_pattern_rule():
    """Full-word constants keep their top bit: the int32 tensor holds the
    uint32 bit pattern, and converts back unchanged."""
    a = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    t = u32_to_tensor(a, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert np.array_equal(tensor_to_u32(t), a)
    assert tm.u32(t).tolist() == [int(v) for v in a]
    with pytest.raises(ValueError):
        u32_to_tensor(np.array([-1]), "cpu")
