"""The port's Galois gather layer against the JAX reference on the CPU:
the host tables (``galois_eval_perm`` in both frequency orders,
``galois_coeff_tables``), ``ops.galois_banks`` with a shared row,
per-batch rows and ``batch_leading``, and ``ops.galois_digits_banks``
shared, non-shared and at R = 1.  Inputs are seeded numpy arrays handed to
both packages; outputs must be the same integers.  The reference runs its
plain path and, where a case is small, its Pallas kernel in interpret mode
(``use_pallas=True``), as its own kernel tests do."""
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st

from repro.core import params as RP
from repro.kernels import ops as ROPS

from repro_torch import kernels as K
from repro_torch.convert import tensor_to_u32, u32_to_tensor
from repro_torch.core import params as TP
from repro_torch.fhe import rns
from repro_torch.kernels import ops as TOPS

torch.set_num_threads(2)


def _gs(n):
    """Rotations by 1, 2, 3 and n/4 - 1 slots, conjugation and identity."""
    return [pow(5, r, 2 * n) for r in (1, 2, 3, n // 4 - 1)] + [2 * n - 1, 1]


def _idx(rows):
    return torch.from_numpy(np.asarray(rows, dtype=np.int32))


def _stack(seed, primes, shape):
    """(len(primes), *shape) uint32 residues, row p below primes[p]."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=shape, dtype=np.uint32) for q in primes])


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("logn", range(4, 15))
def test_galois_eval_perm_equals_reference(logn, natural):
    n = 1 << logn
    for g in _gs(n):
        got = TP.galois_eval_perm(g, n, natural)
        assert np.array_equal(got, RP.galois_eval_perm(g, n, natural)), g
        assert np.array_equal(np.sort(got), np.arange(n)), g     # a permutation


@pytest.mark.parametrize("logn", [4, 10, 14])
def test_galois_coeff_tables_equal_reference(logn):
    n = 1 << logn
    for g in _gs(n):
        src, pos = TP.galois_coeff_tables(g, n)
        rsrc, rpos = RP.galois_coeff_tables(g, n)
        assert np.array_equal(src, rsrc) and np.array_equal(pos, rpos), g


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("natural", [False, True])
def test_galois_banks_shared_and_per_batch_rows(use_pallas, natural):
    n, B = 256, 5
    primes = rns.make_primes(n, 3)
    x = _stack(1, primes, (B, n))
    rows = np.stack([TP.galois_eval_perm(g, n, natural) for g in _gs(n)[:B]])
    K.reset_counts()
    for row in rows[:2]:
        want = ROPS.galois_banks(x, row, use_pallas=use_pallas, tile=4)
        got = TOPS.galois_banks(u32_to_tensor(x, "cpu"), _idx(row))
        assert np.array_equal(tensor_to_u32(got), np.asarray(want))
    want = ROPS.galois_banks(x, rows, use_pallas=use_pallas, tile=4)
    got = TOPS.galois_banks(u32_to_tensor(x, "cpu"), _idx(rows))
    assert np.array_equal(tensor_to_u32(got), np.asarray(want))
    assert K.snapshot()["galois_banks"] == {"launches": 0, "plain_calls": 2}
    assert K.snapshot()["galois_banks_multi"] == {"launches": 0, "plain_calls": 1}


def test_galois_banks_batch_leading():
    """(b, k, n) ciphertext stacks, shared and per-ciphertext rows, and a
    (k, 2, B, n) input whose per-batch rows cover both middle dims."""
    n, B = 64, 3
    primes = rns.make_primes(n, 2)
    xs = np.stack([_stack(10 + b, primes, (n,)) for b in range(B)])   # (B, k, n)
    rows = np.stack([TP.galois_eval_perm(g, n, False) for g in _gs(n)[:B]])
    for idx in (rows[0], rows):
        want = ROPS.galois_banks(xs, idx, batch_leading=True)
        got = TOPS.galois_banks(u32_to_tensor(xs, "cpu"), _idx(idx), batch_leading=True)
        assert np.array_equal(tensor_to_u32(got), np.asarray(want))
    x4 = _stack(20, primes, (2, B, n))
    rows6 = np.concatenate([rows, rows[::-1]])
    want = ROPS.galois_banks(x4, rows6)
    got = TOPS.galois_banks(u32_to_tensor(x4, "cpu"), _idx(rows6))
    assert np.array_equal(tensor_to_u32(got), np.asarray(want))
    with pytest.raises(ValueError, match="per-batch idx"):
        TOPS.galois_banks(u32_to_tensor(x4, "cpu"), _idx(rows))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["shared", "non-shared", "R=1"])
def test_galois_digits_banks_equals_reference(use_pallas, case):
    n, d, R = 128, 3, 5
    primes = rns.make_primes(n, 3)
    b = {"shared": 1, "non-shared": R, "R=1": 1}[case]
    rs = R if case != "R=1" else 1
    x = np.stack([_stack(30 + i, primes, (b, n)) for i in range(d)])      # (d, k, b, n)
    rows = np.stack([TP.galois_eval_perm(g, n, False) for g in _gs(n)[:rs]])
    want = ROPS.galois_digits_banks(x, rows, use_pallas=use_pallas, tile=4)
    K.reset_counts()
    got = TOPS.galois_digits_banks(u32_to_tensor(x, "cpu"), _idx(rows))
    assert got.shape == (d, len(primes), rs, n)
    assert np.array_equal(tensor_to_u32(got), np.asarray(want))
    assert K.snapshot()["galois_digits"] == {"launches": 0, "plain_calls": 1}


def test_galois_digits_banks_rejects_mismatched_rows():
    x = torch.zeros((2, 2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="idx"):
        TOPS.galois_digits_banks(x, torch.zeros((2, 16), dtype=torch.int32))


@settings(deadline=None, database=None, max_examples=20)
@given(st.integers(4, 11), st.integers(1, 6), st.integers(0, 1 << 30),
       st.integers(0, 1))
def test_galois_banks_per_batch_property(logn, B, seed, natural):
    """Any ring size, batch and seed: per-batch rows equal the reference,
    and applying sigma_g then sigma_{g^-1} gives the input back."""
    n = 1 << logn
    primes = rns.make_primes(n, 2)
    rng = np.random.default_rng(seed)
    gs = [pow(5, int(r), 2 * n) for r in rng.integers(0, n // 2, size=B)]
    x = _stack(seed, primes, (B, n))
    rows = np.stack([TP.galois_eval_perm(g, n, bool(natural)) for g in gs])
    back = np.stack([TP.galois_eval_perm(pow(g, -1, 2 * n), n, bool(natural))
                     for g in gs])
    got = TOPS.galois_banks(u32_to_tensor(x, "cpu"), _idx(rows))
    assert np.array_equal(tensor_to_u32(got), np.asarray(ROPS.galois_banks(x, rows)))
    assert np.array_equal(tensor_to_u32(TOPS.galois_banks(got, _idx(back))), x)


def _mixed_rows(seed, rows, n):
    """(rows, n) int32 indices drawn from [-2n, 2n): in the row, counted
    from its end ([-n, 0)) and outside it on both sides."""
    return np.random.default_rng(seed).integers(-2 * n, 2 * n, (rows, n)).astype(np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n", [16, 64])
def test_gathers_take_indices_as_the_reference(use_pallas, n):
    """Indices in [-n, 0) count from the end of the row (n + i) and any
    other outside [0, n) gives 0xFFFFFFFF, as the reference's jnp.take /
    take_along_axis: a shared row, per-batch rows, the digit gather and its
    fan-out mode, word for word against the reference's plain path and its
    Pallas kernels in interpret mode."""
    B, d = 4, 2
    primes = rns.make_primes(n, 3)
    rows = _mixed_rows(n, B, n)
    assert (rows < -n).any() and ((rows >= -n) & (rows < 0)).any() and (rows >= n).any()
    x = _stack(n, primes, (B, n))
    for idx in (rows[0], rows):
        want = np.asarray(ROPS.galois_banks(x, idx, use_pallas=use_pallas, tile=4))
        got = tensor_to_u32(TOPS.galois_banks(u32_to_tensor(x, "cpu"), _idx(idx)))
        assert np.array_equal(got, want), idx.shape
    ext = np.stack([_stack(n + 1 + i, primes, (B, n)) for i in range(d)])     # (d, k, B, n)
    for xs in (ext, ext[:, :, :1].copy()):                                   # per row, fan-out
        want = np.asarray(ROPS.galois_digits_banks(xs, rows, use_pallas=use_pallas, tile=4))
        got = tensor_to_u32(TOPS.galois_digits_banks(u32_to_tensor(xs, "cpu"), _idx(rows)))
        assert got.shape == (d, len(primes), B, n) and np.array_equal(got, want), xs.shape
    outside = (rows < -n) | (rows >= n)
    got = tensor_to_u32(TOPS.galois_banks(u32_to_tensor(x, "cpu"), _idx(rows)))
    assert (got[:, outside] == 0xFFFFFFFF).all()
    back = np.where(rows < 0, rows + n, rows)
    inside = ~outside
    assert np.array_equal(got[:, inside],
                          np.take_along_axis(x, np.where(inside, back, 0)[None], -1)[:, inside])
