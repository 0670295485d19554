"""The port's key switch (paper Fig 22) against the JAX reference on the
CPU: the centered mod-up, the digit decomposition, the digit MAC with
shared and per-batch keys, the mod-down, and the whole batched key
switch — on the single-kernel path and on a four-step pack.  The
reference's packs and keys are carried across with
``convert.from_reference``; every output must be bit-identical."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fhe import batched as RB
from repro.fhe import rns as RR
from repro.kernels import ops as RO

from repro_torch.convert import from_reference, tensor_to_u32, u32_to_tensor
from repro_torch.fhe import batched as TB
from repro_torch.kernels import ops as TO

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

N = 1 << 10
PRIMES = tuple(RR.make_primes(N, 4))        # 3 basis primes + special (last)
K = len(PRIMES) - 1
B = 2


def _paths():
    """name -> (reference t, reference fsp, port t, port fsp)."""
    t = RB.build_table_pack(list(PRIMES), N)
    s = RB.build_scalar_pack(list(PRIMES))
    fs = RB.build_fourstep_pack(list(PRIMES), N)     # 32 x 32
    return {"single": (t, None, from_reference(t, "cpu"), None),
            "fourstep": (s, fs, from_reference(s, "cpu"), from_reference(fs, "cpu"))}


PATHS = _paths()


def _residues(seed, primes, mid):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=mid + (N,), dtype=np.uint32)
                     for q in primes])


def _keys(seed, mid=()):
    """(k, k+1, [B,] n) key digits over basis + special."""
    return np.stack([_residues(seed + i, PRIMES, mid) for i in range(K)])


def _same(ref_out, port_out):
    return np.array_equal(np.asarray(ref_out), tensor_to_u32(port_out))


def test_extend_centered_matches_reference():
    src = PRIMES[0]
    rng = np.random.default_rng(3)
    c = rng.integers(0, src, size=(B, N), dtype=np.uint32)
    c[0, :6] = [0, 1, src // 2, src // 2 + 1, src - 1, src - 2]
    qs = np.array(PRIMES, dtype=np.uint32)
    r = RB.extend_centered(jnp.asarray(c), jnp.uint32(src), jnp.asarray(qs))
    p = TB.extend_centered(u32_to_tensor(c, "cpu"), u32_to_tensor(np.uint32(src), "cpu"),
                           u32_to_tensor(qs, "cpu"))
    assert _same(r, p)


@pytest.mark.parametrize("path", ["single", "fourstep"])
def test_decompose_banks_matches_reference(path):
    rt, rfs, pt, pfs = PATHS[path]
    d2 = _residues(5, PRIMES[:K], (B,))
    r = RB.decompose_banks(jnp.asarray(d2), rt, fsp=rfs, use_pallas=False)
    p = TB.decompose_banks(u32_to_tensor(d2, "cpu"), pt, fsp=pfs)
    assert p.shape == (K, K + 1, B, N) and _same(r, p)


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_dyadic_inner_banks_matches_reference(per_batch, lazy):
    rt, _, pt, _ = PATHS["single"]
    ext = np.stack([_residues(40 + d, PRIMES, (B,)) for d in range(K)])
    evk = _keys(60, (B,) if per_batch else ())
    r = RO.dyadic_inner_banks(jnp.asarray(ext), jnp.asarray(evk), rt,
                              use_pallas=False, lazy=lazy)
    p = TO.dyadic_inner_banks(u32_to_tensor(ext, "cpu"), u32_to_tensor(evk, "cpu"),
                              pt, lazy=lazy)
    assert _same(r, p)


@pytest.mark.parametrize("path", ["single", "fourstep"])
def test_mod_down_banks_matches_reference(path):
    rt, rfs, pt, pfs = PATHS[path]
    acc = _residues(7, PRIMES, (B,))
    r = RB.mod_down_banks(jnp.asarray(acc), rt, fsp=rfs, use_pallas=False)
    p = TB.mod_down_banks(u32_to_tensor(acc, "cpu"), pt, fsp=pfs)
    assert _same(r, p)


@pytest.mark.parametrize("path", ["single", "fourstep"])
@pytest.mark.parametrize("per_batch", [False, True])
def test_batched_keyswitch_matches_reference(path, per_batch):
    rt, rfs, pt, pfs = PATHS[path]
    d2 = _residues(9, PRIMES[:K], (B,))
    mid = (B,) if per_batch else ()
    evk_b, evk_a = _keys(100, mid), _keys(200, mid)
    r0, r1 = RB.batched_keyswitch(jnp.asarray(d2), jnp.asarray(evk_b),
                                  jnp.asarray(evk_a), rt, fsp=rfs, use_pallas=False)
    p0, p1 = TB.batched_keyswitch(*from_reference((d2, evk_b, evk_a), "cpu"),
                                  pt, fsp=pfs)
    assert _same(r0, p0) and _same(r1, p1)


# ------------------------------- the host oracle and the rest of the API

from repro.fhe import keyswitch as RK                    # noqa: E402
from repro.fhe.ckks import CkksContext as RefContext     # noqa: E402

from repro_torch.convert import tensor_to_u32 as _u32    # noqa: E402
from repro_torch.fhe import keyswitch as TK              # noqa: E402
from repro_torch.fhe import rns as TR                    # noqa: E402
from repro_torch.fhe.ckks import CkksContext             # noqa: E402


def _polys(rows, primes):
    """The same NTT-form residue rows as a reference and a port RnsPoly."""
    return (RR.RnsPoly(jnp.asarray(rows), tuple(primes), True),
            TR.RnsPoly(u32_to_tensor(rows, "cpu"), tuple(primes), True))


def test_rns_helpers_match_reference():
    q = PRIMES[1]
    row = np.random.default_rng(11).integers(0, q, N, dtype=np.uint32)
    row[:4] = [0, q // 2, q // 2 + 1, q - 1]
    assert np.array_equal(RR.center_row(row, q), TR.center_row(row, q))
    r = RR.extend_single(row, q, PRIMES)
    p = TR.extend_single(row, q, PRIMES, "cpu")
    assert not p.is_ntt and p.primes == PRIMES and _same(r.data, p.data)
    rp, pp = RR.prime_params(N, q), TR.prime_params(N, q)
    assert pp is TR.prime_params(N, q)
    for name in ("tw", "twp", "itw", "itwp", "psi_pows", "ipsi_ninv"):
        assert np.array_equal(np.asarray(getattr(rp, name)), getattr(pp, name)), name


def test_table_pack_and_per_prime_transforms_match_reference():
    rt, _, pt, _ = PATHS["single"]
    shapes = TB.table_pack_shapes(K + 1, N)
    ref_shapes = RB.table_pack_shapes(K + 1, N)
    assert set(shapes) == set(ref_shapes) == set(pt)
    for name, meta in shapes.items():
        assert meta.device.type == "meta" and meta.dtype == torch.int32
        assert tuple(meta.shape) == ref_shapes[name].shape == tuple(pt[name].shape), name
    fields = {f: pt[f] for f in TB.TablePack.__dataclass_fields__}
    tree = TB.TablePack(**fields).tree()
    assert list(tree) == list(fields) and all(torch.equal(tree[f], v) for f, v in fields.items())
    for i in (0, 2):
        xi = _residues(13 + i, PRIMES[i:i + 1], (B,))[0]
        f = TB.ntt_fwd_i(u32_to_tensor(xi, "cpu"), pt, i)
        assert _same(RB.ntt_fwd_i(jnp.asarray(xi), rt, i), f)
        assert _same(RB.ntt_inv_i(jnp.asarray(xi), rt, i),
                     TB.ntt_inv_i(u32_to_tensor(xi, "cpu"), pt, i))
        assert np.array_equal(_u32(TB.ntt_inv_i(f, pt, i)), xi)


def test_mod_down_by_last_matches_reference():
    r, p = _polys(_residues(21, PRIMES, ()), PRIMES)
    rd, pd = RK.mod_down_by_last(r), TK.mod_down_by_last(p)
    assert pd.primes == PRIMES[:-1] and pd.is_ntt and _same(rd.data, pd.data)
    with pytest.raises(ValueError, match="NTT form"):
        TK.mod_down_by_last(p.to_coeff())


def test_keyswitch_oracle_matches_reference_and_batched_keyswitch():
    """The host oracle (digit loop, host mod-up) equals the reference's
    oracle and the port's fused batched_keyswitch on the same digits."""
    d2 = _residues(22, PRIMES[:K], ())
    evk_b, evk_a = _keys(300), _keys(400)
    rd2, pd2 = _polys(d2, PRIMES[:K])
    rev = [tuple(_polys(k[i], PRIMES)[0] for k in (evk_b, evk_a)) for i in range(K)]
    pev = [tuple(_polys(k[i], PRIMES)[1] for k in (evk_b, evk_a)) for i in range(K)]
    r0, r1 = RK.keyswitch(rd2, rev, PRIMES[-1])
    p0, p1 = TK.keyswitch(pd2, pev, PRIMES[-1])
    assert _same(r0.data, p0.data) and _same(r1.data, p1.data)
    _, _, pt, _ = PATHS["single"]
    b0, b1 = TB.batched_keyswitch(u32_to_tensor(d2[:, None], "cpu"),
                                  u32_to_tensor(evk_b, "cpu"),
                                  u32_to_tensor(evk_a, "cpu"), pt)
    assert torch.equal(b0[:, 0], p0.data) and torch.equal(b1[:, 0], p1.data)


def test_add_plain_and_mul_plain_match_reference():
    ref = RefContext(n=N, levels=2, scale_bits=26, seed=41)
    port = CkksContext(n=N, levels=2, scale_bits=26, seed=41, device="cpu")
    z = np.random.default_rng(42).uniform(-1, 1, (2, ref.slots))
    rct, pct = ref.encrypt(ref.encode(z[0])), port.encrypt(port.encode(z[0]))
    rpt, ppt = ref.encode(z[1]), port.encode(z[1])
    for op, kw in (("add_plain", {}), ("mul_plain", {}), ("mul_plain", {"pt_scale": 2.0 ** 20})):
        r, p = getattr(ref, op)(rct, rpt, **kw), getattr(port, op)(pct, ppt, **kw)
        assert _same(r.c0.data, p.c0.data) and _same(r.c1.data, p.c1.data), op
        assert r.scale == p.scale and r.primes == p.primes, op
    got = port.decrypt_decode(port.add_plain(pct, ppt))
    np.testing.assert_allclose(got, z[0] + z[1], atol=1e-3)


def test_prepare_without_relin_draws_keys_in_the_reference_order():
    """``prepare(relin=False)`` draws every Galois key in the reference's
    order and no relinearization key: the same keys, and the contexts'
    generators in the same state afterwards (the next ciphertext is the
    same).  With the key, tests/test_torch_rotate.py prepares alike."""
    prepare = dict(relin=False, rotations=(1, 2), conjugate=True, hoisted_sets=((1, 3),))
    ref = RefContext(n=256, levels=2, scale_bits=26, seed=91)
    port = CkksContext(n=256, levels=2, scale_bits=26, seed=91, device="cpu")
    ref.plan().prepare(warm_jit=False, **prepare)
    port.plan().prepare(**prepare)
    assert sorted(ref.plan()._keys) == sorted(port.plan()._keys)
    assert ("relin", port.qs) not in port.plan()._keys
    for key, (rb, ra) in ref.plan()._keys.items():
        pb, pa = port.plan()._keys[key]
        assert _same(rb, pb) and _same(ra, pa), key
    z = np.linspace(-1, 1, ref.slots)
    r, p = ref.encrypt(ref.encode(z)), port.encrypt(port.encode(z))
    assert _same(r.c0.data, p.c0.data) and _same(r.c1.data, p.c1.data)


# ---------------------------------------- the digit MAC's two-key, strided form

def _t(a):
    return u32_to_tensor(a, "cpu")


def _old_macs(y, evk_b, evk_a, t, lazy=True):
    """The digit MACs as two one-key calls on a contiguous copy of y."""
    y = y.contiguous()
    return (TO.dyadic_inner_banks(y, evk_b, t, lazy=lazy),
            TO.dyadic_inner_banks(y, evk_a, t, lazy=lazy))


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_digit_mac_pair_reads_the_transposed_stack(per_batch, lazy):
    """Both keys in one call on the (digit, prime, B, n) transpose of a
    (prime, digit, B, n) stack, into fresh stacks and into the two halves
    of one (k+1, 2B, n) stack, equal two one-key calls on a copy."""
    _, _, pt, _ = PATHS["single"]
    stack = _t(np.stack([_residues(80 + p, (q,) * K, (B,))
                         for p, q in enumerate(PRIMES)]))        # (k+1, K, B, n)
    y = stack.transpose(0, 1)
    mid = (B,) if per_batch else ()
    evk_b, evk_a = _t(_keys(300, mid)), _t(_keys(400, mid))
    want = _old_macs(y, evk_b, evk_a, pt, lazy)
    got = TO.dyadic_inner_banks(y, (evk_b, evk_a), pt, lazy=lazy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    acc = torch.empty((K + 1, 2 * B, N), dtype=torch.int32)
    TO.dyadic_inner_banks(y, (evk_b, evk_a), pt, lazy=lazy, out=(acc[:, :B], acc[:, B:]))
    assert torch.equal(acc, torch.cat(want, dim=1))


@pytest.mark.parametrize("path", ["single", "fourstep"])
@pytest.mark.parametrize("per_batch", [False, True])
def test_keyswitch_digits_words_unchanged(path, per_batch):
    """``keyswitch_digits`` gives the words of the two one-key MACs on a
    contiguous copy of the mod-up's output, then the two mod-downs."""
    _, _, pt, pfs = PATHS[path]
    ci = TB.decompose_intt(_t(_residues(11, PRIMES[:K], (B,))), pt, fsp=pfs)
    mid = (B,) if per_batch else ()
    evk_b, evk_a = _t(_keys(500, mid)), _t(_keys(600, mid))
    y = TB.decompose_extend(ci, pt["qs"], pt, fsp=pfs)
    want = [TB.mod_down_banks(acc, pt, fsp=pfs) for acc in _old_macs(y, evk_b, evk_a, pt)]
    got = TB.keyswitch_digits(ci, pt["qs"], evk_b, evk_a, pt, fsp=pfs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("path", ["single", "fourstep"])
def test_hoisted_rotations_words_unchanged(path):
    """``hoisted_rotations_banks`` gives the words of the two one-key MACs
    concatenated on the batch axis, then one mod-down with c0's gather."""
    from repro_torch.fhe import evalplan as TEP
    _, _, pt, pfs = PATHS[path]
    R = 3
    rng = np.random.default_rng(13)
    c0, c1 = (_t(_residues(s, PRIMES[:K], ())) for s in (14, 15))
    idx = torch.from_numpy(np.stack([rng.permutation(N) for _ in range(R)])
                           .astype(np.int32))
    evk_b, evk_a = _t(_keys(700, (R,))), _t(_keys(800, (R,)))
    ci = TB.decompose_intt(c1[:, None], pt, fsp=pfs)
    yg = TO.galois_digits_banks(TB.decompose_extend(ci, pt["qs"], pt, fsp=pfs), idx)
    c0g = TO.galois_digits_banks(c0[None, :, None], idx)[0]
    ks = TB.mod_down_banks(torch.cat(_old_macs(yg, evk_b, evk_a, pt), dim=1), pt,
                           fsp=pfs, addend=c0g)
    got = TEP.hoisted_rotations_banks(c0, c1, idx, evk_b, evk_a, pt, pfs)
    assert torch.equal(got[0], ks[:, :R]) and torch.equal(got[1], ks[:, R:])


@pytest.mark.parametrize("meta", [False, True], ids=["counted", "meta"])
def test_keyswitch_is_one_mac_launch_on_the_strided_stack(meta):
    """A key switch runs the digit MAC once for both key halves, reading
    the mod-up's transposed stack in place: one plain call on the CPU, one
    launch recorded on meta tensors, and one ``ops.dyadic_inner.strided``."""
    from repro_torch import kernels
    from repro_torch import obs
    from repro_torch.runtime import op_cost
    _, _, pt, pfs = PATHS["fourstep"]
    to = (lambda v: v.to("meta")) if meta else (lambda v: v)
    tree = lambda d: {k: (tree(v) if isinstance(v, dict) else to(v)) for k, v in d.items()}
    d2 = to(_t(_residues(17, PRIMES[:K], (B,))))
    evk_b, evk_a = to(_t(_keys(900))), to(_t(_keys(1000)))
    kernels.reset_counts()
    obs.enable()
    obs.reset()
    try:
        with op_cost.OpCounter() as c:
            TB.batched_keyswitch(d2, evk_b, evk_a, tree(pt), fsp=tree(pfs))
        counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    launches = (c.kernels.get("dyadic_inner_banks", 0) if meta
                else kernels.COUNTS["dyadic_inner_banks"].plain_calls)
    assert launches == 1
    assert counters.get("ops.dyadic_inner.strided") == 1


def test_digit_mac_refuses_a_strided_ring_axis():
    """On the kernel's branch (meta tensors pass its checks) an ext whose
    ring axis is not unit-stride, or a key or output so, is refused."""
    from repro_torch.kernels import KernelRefusal, dyadic_kernel
    _, _, pt, _ = PATHS["single"]
    qs, mu = pt["qs"].to("meta"), pt["mu"].to("meta")
    wide = torch.empty((K, K + 1, B, 2 * N), dtype=torch.int32, device="meta")
    key = torch.empty((K, K + 1, N), dtype=torch.int32, device="meta")
    with pytest.raises(KernelRefusal, match="unit-stride along n"):
        dyadic_kernel.dyadic_inner_banks(wide[..., ::2], (key, key), qs, mu, lazy=True)
    with pytest.raises(KernelRefusal, match="unit-stride along n"):
        dyadic_kernel.dyadic_inner_banks(wide[..., :N], wide[:, :, 0, ::2], qs, mu, lazy=True)
    out = torch.empty((K + 1, B, 2 * N), dtype=torch.int32, device="meta")
    with pytest.raises(KernelRefusal, match="unit-stride along n"):
        dyadic_kernel.dyadic_inner_banks(wide[..., :N], key, qs, mu, lazy=True,
                                         out=out[..., ::2])
    got = dyadic_kernel.dyadic_inner_banks(wide[..., N:], (key, key), qs, mu, lazy=True)
    assert [tuple(g.shape) for g in got] == [(K + 1, B, N)] * 2
