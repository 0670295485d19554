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
