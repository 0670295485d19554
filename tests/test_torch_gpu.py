"""The port's CUDA kernels against their plain PyTorch versions on the
card, for every ring size the NTT kernels take (the banks at 2 .. 2^17:
one launch up to 4096, two passes through scratch above; fewer stages
than log2 n; an unaligned view), both key layouts of the
digit MAC, ragged batches, the weight-row multiply on its vector and
scalar paths (the main path's shapes, an unaligned view, x over the
whole u32 range), the Galois gathers in both bit orders (shared and
per-batch rows, digits shared and not, the staged body at the path's
shapes and on rows of 4, 8 and 12 words with odd row counts and indices
outside the row, its plan() against the CPU emulation's, rows above one
block's shared memory at 2^16 and 2^17, indices drawn from [-2n, 2n)),
and the u16 lane of ML-KEM's ring (the 7-stage transforms on n = 256 and
the basecase product, at odd and ML-KEM-sized batches; the product on
both its bodies at 2 .. 4096 words, one and three moduli, an unaligned
view, and its plan() against the CPU emulation's), and the single-prime transforms and Barrett products
(n = 2 .. 2^17: the row stream from 64 to 4096 words at one row and at
uneven row counts, the row body below it and on unaligned views, the
one-prime bank above 4096, with ops' any-leading-shape rows); and rotate,
rotate_many, rotate_hoisted and the matvec at 2^16 against the port's
CPU run.  Marked ``gpu``: they skip where no CUDA device is present.  On
a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.convert import from_reference
from repro_torch.core.ringspec import MLKEM_RING, ring_table_pack
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.core.params import galois_eval_perm, make_ntt_params
from repro_torch.kernels import build, dyadic_kernel, galois_kernel, ntt_kernel, ops, ref

import basemul_schedule
import galois_schedule

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _residues(seed, qs, shape, band=1):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, band * int(q), size=shape, dtype=np.int64) for q in qs]
    return torch.from_numpy(np.stack(rows).astype(np.int32)).cuda()


@pytest.mark.parametrize("logn", range(1, 18))
@pytest.mark.parametrize("b", [1, 7, 37])
@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_banks_kernels_equal_plain(cuda, logn, b, lazy):
    """Every ring the u32 banks take: one launch of the register body up
    to 4096 words, two passes through scratch from 8192 to 2^17; one row,
    an odd count, and counts that fill no warp or block."""
    n = 1 << logn
    primes = rns.make_primes(max(n, 16), 3)
    t = TB.build_table_pack(primes, n, cuda)
    x = _residues(logn, primes, (b, n), band=2 if lazy else 1)
    xr = _residues(logn + 100, primes, (b, n))
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    for reduce_out in (False, True):
        for neg in (False, True):
            K.reset_counts()
            got = ntt_kernel.ntt_fwd_banks(xr, *fargs, negacyclic=neg, lazy=lazy,
                                           reduce_out=reduce_out)
            want = ref.ntt_fwd_banks_ref(xr, *fargs, neg, lazy=lazy, reduce_out=reduce_out)
            assert torch.equal(got, want), ("fwd", n, lazy, reduce_out, neg)
            got = ntt_kernel.ntt_inv_banks(x, *iargs, negacyclic=neg, lazy=lazy,
                                           reduce_out=reduce_out)
            want = ref.ntt_inv_banks_ref(x, *iargs, neg, lazy=lazy, reduce_out=reduce_out)
            assert torch.equal(got, want), ("inv", n, lazy, reduce_out, neg)
            assert K.COUNTS["ntt_fwd_banks"].launches == 1
            assert K.COUNTS["ntt_inv_banks"].launches == 1


@pytest.mark.parametrize("logn", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_banks_both_bodies_equal_plain(cuda, logn, lazy):
    """Rings of 16 .. 256 words take 4 words a thread below one warp per SM
    and 16 above it: 2 and 300 rows of 3 primes land on either side."""
    n = 1 << logn
    primes = rns.make_primes(n, 3)
    t = TB.build_table_pack(primes, n, cuda)
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    for b in (2, 300):
        x = _residues(logn + b, primes, (b, n), band=2 if lazy else 1)
        xr = _residues(logn + b + 1, primes, (b, n))
        for neg in (False, True):
            kw = dict(negacyclic=neg, lazy=lazy, reduce_out=True)
            assert torch.equal(ntt_kernel.ntt_fwd_banks(xr, *fargs, **kw),
                               ref.ntt_fwd_banks_ref(xr, *fargs, **kw)), ("fwd", b, neg)
            assert torch.equal(ntt_kernel.ntt_inv_banks(x, *iargs, **kw),
                               ref.ntt_inv_banks_ref(x, *iargs, **kw)), ("inv", b, neg)


@pytest.mark.parametrize("n,stages", [(128, 5), (256, 7), (4096, 9), (1 << 15, 3),
                                      (1 << 15, 14)])
@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_banks_with_fewer_stages_equal_plain(cuda, n, stages, lazy):
    """Stage counts below log2 n on the u32 lane: the words land at
    rotl / rotr of their indices, on both routes."""
    primes = rns.make_primes(n, 2)
    t = TB.build_table_pack(primes, n, cuda)
    for name in ("tw", "twp", "itw", "itwp"):
        t[name] = t[name][:, :stages].contiguous()
    x = _residues(stages, primes, (5, n), band=2 if lazy else 1)
    xr = _residues(stages + 1, primes, (5, n))
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    for neg in (False, True):
        kw = dict(lazy=lazy, reduce_out=not lazy)
        assert torch.equal(ntt_kernel.ntt_fwd_banks(xr, *fargs, negacyclic=neg, **kw),
                           ref.ntt_fwd_banks_ref(xr, *fargs, neg, **kw)), ("fwd", neg)
        assert torch.equal(ntt_kernel.ntt_inv_banks(x, *iargs, negacyclic=neg, **kw),
                           ref.ntt_inv_banks_ref(x, *iargs, neg, **kw)), ("inv", neg)


@pytest.mark.parametrize("n", [128, 1 << 15])
def test_ntt_banks_on_an_unaligned_view(cuda, n):
    """x one word past a 16-byte boundary: the body loads and stores word
    by word instead of as 16-byte vectors."""
    primes = rns.make_primes(n, 2)
    t = TB.build_table_pack(primes, n, cuda)
    words = _residues(n, primes[:1], (2 * 3 * n + 1,))[0]
    x = words[1:].view(2, 3, n)
    assert x.data_ptr() % 16 and x.is_contiguous()
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    kw = dict(negacyclic=True, lazy=True, reduce_out=True)
    assert torch.equal(ntt_kernel.ntt_fwd_banks(x, *fargs, **kw),
                       ref.ntt_fwd_banks_ref(x, *fargs, **kw))
    assert torch.equal(ntt_kernel.ntt_inv_banks(x, *iargs, **kw),
                       ref.ntt_inv_banks_ref(x, *iargs, **kw))


def _twiddle_check(x, fp, lazy):
    K.reset_counts()
    got = ntt_kernel.twiddle_mul_banks(x, fp["qs"], fp["tw"], fp["twp"], lazy=lazy)
    want = ref.twiddle_mul_banks_ref(x, fp["qs"], fp["tw"], fp["twp"], lazy=lazy)
    assert torch.equal(got, want)
    assert K.COUNTS["twiddle_mul_banks"].launches == 1


@pytest.mark.parametrize("shape", [(9, 64, 1 << 14), (9, 1, 1 << 14), (9, 8, 1 << 14),
                                   (3, 5, 1 << 14), (3, 7, 2), (2, 3, 4)])
@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_kernel_equal_plain(cuda, shape, lazy):
    """The four-step pass's shape at B = 8 (9 primes, 64 columns of a
    128 x 128 split of 2^14), the whole 2^14 ring at B = 1 and 8, an odd
    batch, and rings of 2 (the one-word path) and 4 words."""
    k, b, n = shape
    primes = rns.make_primes(max(n, 16), k)
    fp = TB.build_fourstep_pack(primes, n, cuda) if n >= 16 else _weights(primes, n, cuda)
    _twiddle_check(_residues(k * b, primes, (b, n), band=2), fp, lazy)


def _weights(primes, n, device):
    """Random weight rows below each prime and their Shoup companions."""
    rng = np.random.default_rng(n)
    w = np.stack([rng.integers(0, q, n) for q in primes])
    wp = np.stack([[(int(v) << 32) // q for v in row] for row, q in zip(w, primes)])
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.uint32)
                                        .view(np.int32)).to(device)
    return {"qs": as_i32(primes), "tw": as_i32(w), "twp": as_i32(wp)}


@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_kernel_takes_any_u32_representative(cuda, lazy):
    """Shoup's product takes any u32 x, so x covers the whole range,
    the words above 2^31 included (negative int32 bit patterns)."""
    n = 1 << 14
    primes = rns.make_primes(n, 9)
    fp = TB.build_fourstep_pack(primes, n, cuda)
    rng = np.random.default_rng(lazy)
    x = rng.integers(0, 1 << 32, (9, 8, n), dtype=np.uint64).astype(np.uint32)
    x[:, 0, :4] = [0, 1, (1 << 32) - 1, 1 << 31]
    _twiddle_check(torch.from_numpy(x.view(np.int32)).to(cuda), fp, lazy)


@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_kernel_on_an_unaligned_view(cuda, lazy):
    """x one word past a 16-byte boundary takes the one-word path."""
    n = 1 << 10
    primes = rns.make_primes(n, 3)
    fp = TB.build_fourstep_pack(primes, n, cuda)
    words = _residues(1, primes[:1], (3 * 4 * n + 1,))[0]
    x = words[1:].view(3, 4, n)
    assert x.data_ptr() % 16 and x.is_contiguous()
    _twiddle_check(x, fp, lazy)


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_dyadic_inner_kernel_equal_plain(cuda, per_batch, lazy):
    n = 1 << 12
    primes = rns.make_primes(n, 5)
    s = TB.build_scalar_pack(primes, cuda)
    ext = torch.stack([_residues(d, primes, (3, n)) for d in range(4)])
    evk = torch.stack([_residues(10 + d, primes, (3, n) if per_batch else (n,))
                       for d in range(4)])
    got = dyadic_kernel.dyadic_inner_banks(ext, evk, s["qs"], s["mu"], lazy=lazy)
    assert torch.equal(got, ref.dyadic_inner_banks_ref(ext, evk, s["qs"], s["mu"],
                                                       lazy=lazy))


def test_wrong_device_table_is_refused(cuda):
    n = 64
    primes = rns.make_primes(n, 2)
    t = TB.build_table_pack(primes, n, cuda)
    x = _residues(1, primes, (2, n))
    with pytest.raises(ValueError, match="is on cpu"):
        ntt_kernel.twiddle_mul_banks(x, t["qs"].cpu(), t["psi"], t["psip"], lazy=False)


def _rotation_rows(n, amounts, natural=True, conjugate=False):
    gs = [pow(5, r, 2 * n) for r in amounts] + ([2 * n - 1] if conjugate else [])
    return torch.from_numpy(np.stack([galois_eval_perm(g, n, natural)
                                      for g in gs]).astype(np.int32)).cuda()


@pytest.mark.parametrize("logn,natural", [(4, False), (10, False), (10, True),
                                          (14, True)])
def test_galois_banks_kernels_equal_plain(cuda, logn, natural):
    n = 1 << logn
    primes = rns.make_primes(n, 3)
    gs = [pow(5, r, 2 * n) for r in (1, 2, 3)] + [2 * n - 1, 1]
    rows = torch.from_numpy(np.stack([galois_eval_perm(g, n, natural)
                                      for g in gs]).astype(np.int32)).cuda()
    x = _residues(logn, primes, (len(gs), n))
    K.reset_counts()
    for r in range(len(gs)):
        assert torch.equal(galois_kernel.galois_banks(x, rows[r]),
                           ref.galois_banks_ref(x, rows[r])), ("shared", r)
    assert torch.equal(galois_kernel.galois_banks_multi(x, rows),
                       ref.galois_banks_ref(x, rows))
    assert K.COUNTS["galois_banks"].launches == len(gs)
    assert K.COUNTS["galois_banks_multi"].launches == 1


@pytest.mark.parametrize("logn,natural", [(10, False), (14, True)])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_galois_digits_kernel_equal_plain(cuda, logn, natural, R):
    n = 1 << logn
    primes = rns.make_primes(n, 4)
    rows = torch.from_numpy(np.stack([galois_eval_perm(pow(5, r, 2 * n), n, natural)
                                      for r in range(1, R + 1)]).astype(np.int32)).cuda()
    x = torch.stack([_residues(10 * d + R, primes, (R, n)) for d in range(3)])
    got = galois_kernel.galois_digits(x, rows, shared=False)
    assert torch.equal(got, ref.galois_digits_banks_ref(x, rows))
    one = x[:, :, :1].contiguous()
    shared = R != 1
    got = galois_kernel.galois_digits(one, rows, shared=shared)
    assert got.shape == (3, len(primes), R, n)
    assert torch.equal(got, ref.galois_digits_banks_ref(one, rows))
    # the c0 call of the hoisted program: one "digit"
    assert torch.equal(galois_kernel.galois_digits(one[:1], rows, shared=shared),
                       ref.galois_digits_banks_ref(one[:1], rows))


@pytest.mark.parametrize("shape", [(8, 1, 1 << 14), (8, 8, 1 << 14), (3, 2, 8),
                                   (1, 1, 4), (9, 3, 4096)])
def test_galois_banks_split_rows_equal_plain(cuda, shape):
    """The shared-index gather splits every output row across blocks: a
    rotate's (8, 1, 2^14), B > 1, and rows of one or two vectors."""
    k, b, n = shape
    primes = rns.make_primes(max(n, 16), k)
    rows = _rotation_rows(n, (1, 5), natural=n >= 8) if n >= 8 else \
        torch.tensor([[3, 0, 2, 1]], dtype=torch.int32, device=cuda)
    x = _residues(k * b + n, primes, (b, n))
    K.reset_counts()
    for r in range(rows.shape[0]):
        assert torch.equal(galois_kernel.galois_banks(x, rows[r]),
                           ref.galois_banks_ref(x, rows[r])), r
    assert K.COUNTS["galois_banks"].launches == rows.shape[0]


@pytest.mark.parametrize("n", [galois_kernel.MAX_ROW + 4, 1 << 16, 1 << 17])
def test_gathers_above_one_blocks_shared_memory_equal_plain(cuda, n):
    """Rows longer than a block's shared memory holds: the split-row body
    of the shared index (galois_banks), and the piece ring of the staged
    body in the per-row index (galois_banks_multi, galois_digits) and
    fan-out (galois_digits with ``shared``) modes.  n = MAX_ROW + 4 is no
    ring size (a random permutation) and ends in a short piece."""
    primes = rns.make_primes(1 << 16, 3)
    if n & (n - 1):
        rng = np.random.default_rng(n)
        rows = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(3)])
                                .astype(np.int32)).cuda()
    else:
        rows = _rotation_rows(n, (1, 2), conjugate=True)
    b = rows.shape[0]
    x = _residues(n, primes, (b, n))
    ext = torch.stack([_residues(n + d, primes, (b, n)) for d in range(2)])
    one = ext[:, :, :1].contiguous()
    K.reset_counts()
    assert torch.equal(galois_kernel.galois_banks(x, rows[1]),
                       ref.galois_banks_ref(x, rows[1]))
    assert torch.equal(galois_kernel.galois_banks_multi(x, rows),
                       ref.galois_banks_ref(x, rows))
    assert torch.equal(galois_kernel.galois_digits(ext, rows, shared=False),
                       ref.galois_digits_banks_ref(ext, rows))
    assert torch.equal(galois_kernel.galois_digits(one, rows, shared=True),
                       ref.galois_digits_banks_ref(one, rows))
    c = K.snapshot()
    assert [c[k]["launches"] for k in ("galois_banks", "galois_banks_multi",
                                       "galois_digits")] == [1, 1, 2]


def _gather_rows(n, R, seed):
    """R gather rows of n words: rotations where n is a ring size of 8 or
    more, random permutations otherwise."""
    if n >= 8 and n & (n - 1) == 0:
        return _rotation_rows(n, range(1, R + 1))
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(n) for _ in range(R)])
                            .astype(np.int32)).cuda()


# (k, B, n) of galois_banks_multi: a mixed rotate_many of 8 at 2^14, 2^16
# and 2^17, rows of one to three vectors and a 1024-word ring, with odd
# row counts and B that no run count divides
MULTI_SHAPES = [(8, 8, 1 << 14), (8, 8, 1 << 16), (3, 2, 1 << 17), (3, 5, 4), (5, 3, 8),
                (7, 3, 12), (7, 3, 1024)]
# (d, k, R, n) of galois_digits: the hoisted R = 8 rotation's digit gather
# (8, 9, 1, n) and its c0 gather (1, 8, 1, n) at 2^14, 2^16 and 2^17, and
# small rows with odd row counts
DIGIT_SHAPES = [(8, 9, 8, 1 << 14), (1, 8, 8, 1 << 14), (8, 9, 8, 1 << 16), (1, 8, 8, 1 << 16),
                (2, 3, 8, 1 << 17), (1, 3, 8, 1 << 17), (3, 3, 3, 4), (3, 5, 5, 8),
                (1, 7, 3, 12), (3, 3, 7, 1024)]


@pytest.mark.parametrize("shape", MULTI_SHAPES, ids=str)
def test_staged_multi_gather_equals_plain(cuda, shape):
    """galois_banks_multi on the staged body equals its plain version."""
    k, b, n = shape
    primes = rns.make_primes(max(n, 16), k)
    rows = _gather_rows(n, b, n)
    x = _residues(k * b + n, primes, (b, n))
    K.reset_counts()
    assert torch.equal(galois_kernel.galois_banks_multi(x, rows), ref.galois_banks_ref(x, rows))
    assert K.COUNTS["galois_banks_multi"].launches == 1


@pytest.mark.parametrize("shape", DIGIT_SHAPES, ids=str)
def test_staged_digit_gathers_equal_plain(cuda, shape):
    """galois_digits fanned out from one digit stack (the hoisted path's
    shared mode) and per row (non-shared) equal their plain versions."""
    d, k, R, n = shape
    primes = rns.make_primes(max(n, 16), k)
    rows = _gather_rows(n, R, n + d)
    one = torch.stack([_residues(n + j, primes, (1, n)) for j in range(d)])
    K.reset_counts()
    got = galois_kernel.galois_digits(one, rows, shared=True)
    assert got.shape == (d, k, R, n)
    assert torch.equal(got, ref.galois_digits_banks_ref(one, rows))
    ext = torch.stack([_residues(2 * n + j, primes, (R, n)) for j in range(d)])
    assert torch.equal(galois_kernel.galois_digits(ext, rows, shared=False),
                       ref.galois_digits_banks_ref(ext, rows))
    assert K.COUNTS["galois_digits"].launches == 2


@pytest.mark.parametrize("shape", galois_schedule.PATH + [(3, 12, 3, False), (5, 1024, 3, True),
                                                       (1, galois_kernel.MAX_ROW + 4, 1, True)],
                         ids=str)
def test_staged_plan_is_the_emulated_one(cuda, shape):
    """The library's plan() (galois_bulk_parts) cuts each call into the
    runs that the CPU emulation (test_torch_galois_staged.py) takes, on
    this card and on a 132-SM H100."""
    src_rows, n, B, fan_out = shape
    lib = build.load("galois")
    for sms in (torch.cuda.get_device_properties(0).multi_processor_count, 132):
        assert lib.galois_bulk_parts(src_rows, n, B, int(fan_out), sms) == \
            galois_schedule.plan(src_rows, n, B, fan_out, sms), sms


@pytest.mark.parametrize("n", [16, 1 << 14, galois_kernel.MAX_ROW + 4, 1 << 16])
def test_staged_gathers_write_all_ones_outside_the_row(cuda, n):
    """An index outside [-n, n) gives 0xFFFFFFFF in every mode, on whole
    rows and on the piece ring, and -1 reads the row's last word, as in
    the plain versions and the reference's jnp.take (the expectation is
    also built from in-range indices)."""
    R = 3
    rows = _gather_rows(n, R, n).clone()
    rows[0, 0], rows[1, n // 2], rows[2, -1], rows[2, 1] = n, -1, 1 << 30, -n - 5
    bad = (rows < -n) | (rows >= n)
    safe = torch.where(bad, torch.zeros_like(rows), torch.where(rows < 0, rows + n, rows))
    x = _residues(n, rns.make_primes(max(n, 16), 2), (R, n))
    ones = torch.full_like(x, -1)
    want = torch.where(bad.expand_as(x), ones, ref.galois_banks_ref(x, safe))
    assert torch.equal(ref.galois_banks_ref(x, rows), want)
    got = galois_kernel.galois_banks_multi(x, rows)
    assert torch.equal(got, want) and torch.equal(got[:, 1, n // 2], x[:, 1, -1])
    one = x[None, :, :1].contiguous()
    fan = ref.galois_digits_banks_ref(one, safe)
    want = torch.where(bad.expand_as(fan), torch.full_like(fan, -1), fan)
    assert torch.equal(galois_kernel.galois_digits(one, rows, shared=True), want)


@pytest.mark.parametrize("n", [1 << 14, galois_kernel.MAX_ROW + 4, 1 << 16])
def test_gathers_take_indices_as_the_reference(cuda, n):
    """Indices drawn from [-2n, 2n) through all three gathers (the split
    body, the whole-row staged body at 2^14 and the piece ring above one
    block's shared memory), per row and fanned out: one in [-n, 0) counts
    from the end of the row, any other outside [0, n) gives all ones,
    each equal to the plain version."""
    R = 3
    rows = torch.from_numpy(np.random.default_rng(n).integers(-2 * n, 2 * n, (R, n))
                            .astype(np.int32)).cuda()
    primes = rns.make_primes(1 << 16, 2)
    x = _residues(n + 1, primes, (R, n))
    ext = torch.stack([_residues(n + 2 + d, primes, (R, n)) for d in range(2)])
    K.reset_counts()
    assert torch.equal(galois_kernel.galois_banks(x, rows[0]), ref.galois_banks_ref(x, rows[0]))
    assert torch.equal(galois_kernel.galois_banks_multi(x, rows), ref.galois_banks_ref(x, rows))
    for xs, shared in ((ext, False), (ext[:, :, :1].contiguous(), True)):
        assert torch.equal(galois_kernel.galois_digits(xs, rows, shared=shared),
                           ref.galois_digits_banks_ref(xs, rows)), shared
    c = K.snapshot()
    assert [c[k]["launches"] for k in ("galois_banks", "galois_banks_multi",
                                       "galois_digits")] == [1, 1, 2]


def _rotation_traffic(device):
    """rotate, rotate_many, rotate_hoisted and a 4 x 4 matvec at 2^16 with
    3 + 1 ciphertext primes, from one seed."""
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    n = 1 << 16
    rng = np.random.default_rng(16)
    ctx = CkksContext(n=n, levels=3, scale_bits=28, seed=16, device=device)
    M = linalg.PtMatrix.encode(ctx, rng.uniform(-1, 1, (4, 4)) / 4)
    ctx.plan().prepare(rotations=(1, 2), matvecs=(M,))
    zs = [rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2) for _ in range(2)]
    cts = [ctx.encrypt(ctx.encode(z)) for z in zs]
    v = ctx.encrypt(linalg.encode_vector(ctx, rng.uniform(-1, 1, 4), 4))
    out = [ctx.rotate(cts[0], 1), *ctx.rotate_many(cts, (1, 2)),
           *ctx.rotate_hoisted(cts[0], (1, 2)), linalg.matvec(ctx.plan(), M, v)]
    return ctx, zs, out


def test_rotations_at_2_16_equal_the_cpu_run(cuda):
    """The rotation path above MAX_ROW: the card's answers equal the port's
    CPU run word for word, and the card launched all three gathers."""
    K.reset_counts()
    ctx, zs, got = _rotation_traffic(cuda)
    c = K.snapshot()
    for name in ("galois_banks", "galois_banks_multi", "galois_digits"):
        assert c[name]["launches"] > 0 and c[name]["plain_calls"] == 0, name
    assert np.abs(ctx.decrypt_decode(got[0]) - np.roll(zs[0], -1)).max() < 1e-2
    _, _, want = _rotation_traffic("cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.c0.data.cpu(), b.c0.data) and \
            torch.equal(a.c1.data.cpu(), b.c1.data), i


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 18])
def test_gather_rows_of_few_words_equal_plain(cuda, n):
    """Rows that are not a whole number of 16-byte vectors take the
    one-word body: all three gathers, per row and fanned out, on indices
    drawn from [-2n, 2n), each equal to the plain version."""
    R = 3
    rows = torch.from_numpy(np.random.default_rng(n).integers(-2 * n, 2 * n, (R, n))
                            .astype(np.int32)).cuda()
    primes = rns.make_primes(1 << 10, 2)
    x = _residues(n + 1, primes, (R, n))
    ext = torch.stack([_residues(n + 2 + d, primes, (R, n)) for d in range(2)])
    K.reset_counts()
    assert torch.equal(galois_kernel.galois_banks(x, rows[0]), ref.galois_banks_ref(x, rows[0]))
    assert torch.equal(galois_kernel.galois_banks_multi(x, rows), ref.galois_banks_ref(x, rows))
    for xs, shared in ((ext, False), (ext[:, :, :1].contiguous(), True)):
        assert torch.equal(galois_kernel.galois_digits(xs, rows, shared=shared),
                           ref.galois_digits_banks_ref(xs, rows)), shared
    c = K.snapshot()
    assert [c[k]["launches"] for k in ("galois_banks", "galois_banks_multi",
                                       "galois_digits")] == [1, 1, 2]


@pytest.mark.parametrize("n", [64, 1 << 14])
def test_unaligned_gather_row_equals_plain(cuda, n):
    """x and idx views that start one word past a 16-byte boundary, and a
    transposed idx through ops, equal the plain version on all three
    gathers."""
    R = 3
    q = rns.make_primes(n, 1)
    x = _residues(n, q, (2 * R * n + 1,))[0, 1:].view(2, R, n)
    ext = _residues(n + 1, q, (4 * R * n + 1,))[0, 1:].view(2, 2, R, n)
    perm = _rotation_rows(n, (1, 2, 3), natural=n >= ops.FOURSTEP_MIN_N)
    idx = torch.empty(R * n + 1, dtype=torch.int32, device=cuda)[1:].view(R, n)
    idx.copy_(perm)
    assert x.data_ptr() % 16 and ext.data_ptr() % 16 and idx.data_ptr() % 16
    assert torch.equal(galois_kernel.galois_banks(x, idx[0]), ref.galois_banks_ref(x, idx[0]))
    assert torch.equal(galois_kernel.galois_banks_multi(x, idx), ref.galois_banks_ref(x, idx))
    assert torch.equal(galois_kernel.galois_digits(ext, idx, shared=False),
                       ref.galois_digits_banks_ref(ext, idx))
    t = perm.t().contiguous().t()                     # (R, n), not contiguous
    assert torch.equal(ops.galois_banks(x, t), ref.galois_banks_ref(x, perm))
    assert torch.equal(ops.galois_digits_banks(ext[:, :, :1].contiguous(), t),
                       ref.galois_digits_banks_ref(ext[:, :, :1].contiguous(), perm))


def _ring_rows(seed, shape, band=1):
    rng = np.random.default_rng(seed)
    q = MLKEM_RING.q
    return torch.from_numpy(rng.integers(0, band * q, shape).astype(np.int16)).cuda()


@pytest.mark.parametrize("b", [1, 5, 3, 33, 3 * 256, 9 * 256])
@pytest.mark.parametrize("lazy", [False, True])
def test_u16_ntt_and_basemul_kernels_equal_plain(cuda, b, lazy):
    r = from_reference(ring_table_pack(MLKEM_RING), cuda)
    n = MLKEM_RING.n
    fargs = (r["qs"], r["tw"], r["twp"], r["psi"], r["psip"])
    iargs = (r["qs"], r["ninv"], r["ninv_p"], r["itw"], r["itwp"], r["ipsin"], r["ipsinp"])
    x = _ring_rows(b, (1, b, n))
    xi = _ring_rows(b + 1, (1, b, n), band=2 if lazy else 1)
    K.reset_counts()
    for reduce_out in (False, True):
        kw = dict(negacyclic=False, lazy=lazy, reduce_out=reduce_out)
        assert torch.equal(ntt_kernel.ntt_fwd_banks(x, *fargs, **kw),
                           ref.ntt_fwd_banks_ref(x, *fargs, **kw)), ("fwd", reduce_out)
        assert torch.equal(ntt_kernel.ntt_inv_banks(xi, *iargs, **kw),
                           ref.ntt_inv_banks_ref(xi, *iargs, **kw)), ("inv", reduce_out)
    a, c = _ring_rows(b + 2, (1, b, n)), _ring_rows(b + 3, (1, b, n))
    gargs = (r["qs"], r["mu"], r["gamma"], r["gammap"])
    assert torch.equal(dyadic_kernel.dyadic_basemul_banks(a, c, *gargs, lazy=lazy),
                       ref.dyadic_basemul_banks_ref(a, c, *gargs, lazy=lazy))
    c = K.snapshot()
    assert c["ntt_fwd_banks_u16"]["launches"] == 2 and c["ntt_fwd_banks"]["launches"] == 0
    assert c["ntt_inv_banks_u16"]["launches"] == 2 and c["ntt_inv_banks"]["launches"] == 0
    assert c["dyadic_basemul_banks"]["launches"] == 1


def _basemul_plan(k, b, n, aligned, sms):
    """(vector body, pairs an item, threads, items, blocks) as the library
    plans them."""
    out = (ctypes.c_longlong * 5)()
    build.load("dyadic_basemul").dyadic_basemul_plan(k, b, n, int(aligned), sms, out)
    return tuple(out)


@pytest.mark.parametrize("logn", range(1, 13))
@pytest.mark.parametrize("k,b", [(1, 9), (3, 33)])
@pytest.mark.parametrize("lazy", [False, True])
def test_basemul_both_bodies_equal_plain(cuda, logn, k, b, lazy):
    """The basecase product on every ring of 2 .. 4096 words, one and three
    moduli (primes change inside a block): the vector body from n = 4, the
    one-pair body at n = 2 and on a view one word past a 4-byte boundary,
    each equal to the plain version."""
    n = 1 << logn
    a, c, *tabs = (torch.from_numpy(v.view(np.int16)).cuda()
                   for v in basemul_schedule.operands(k, b, n, k * n + b))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert _basemul_plan(k, b, n, True, sms)[0] == (n >= 2 * basemul_schedule.PAIRS)
    K.reset_counts()
    assert torch.equal(dyadic_kernel.dyadic_basemul_banks(a, c, *tabs, lazy=lazy),
                       ref.dyadic_basemul_banks_ref(a, c, *tabs, lazy=lazy))
    words = torch.cat([a.new_zeros(1), a.reshape(-1)])
    view = words[1:].view(a.shape)                            # 2 bytes past a boundary
    assert view.data_ptr() % 4 == 2 and _basemul_plan(k, b, n, False, sms)[0] == 0
    assert torch.equal(dyadic_kernel.dyadic_basemul_banks(view, c, *tabs, lazy=lazy),
                       ref.dyadic_basemul_banks_ref(a, c, *tabs, lazy=lazy))
    assert K.COUNTS["dyadic_basemul_banks"].launches == 2


@pytest.mark.parametrize("shape", [(1, 2304, 256), (1, 768, 256), (1, 9, 256), (1, 3, 256),
                                   (3, 100003, 4096), (3, 33, 4), (1, 5, 2)], ids=str)
def test_basemul_plan_is_the_emulated_one(cuda, shape):
    """The library's plan() (dyadic_basemul_plan) is the one the CPU
    emulation (test_torch_basemul_schedule.py) takes, aligned or not, on
    this card and on a 132-SM H100."""
    k, b, n = shape
    for sms in (torch.cuda.get_device_properties(0).multi_processor_count, 132):
        for aligned in (True, False):
            assert _basemul_plan(k, b, n, aligned, sms) == \
                basemul_schedule.plan(k, b, n, aligned, sms), (sms, aligned)


@pytest.mark.parametrize("n,b", [(n, b) for n in (16, 128, 1024, 4096, 8192, 16384, 1 << 15,
                                                 1 << 16, 1 << 17) for b in (1, 13)]
                         + [(4096, 64), (128, 100_003), (1024, 1003), (2048, 77)])
@pytest.mark.parametrize("lazy", [False, True])
def test_single_prime_kernels_equal_plain(cuda, n, b, lazy):
    """From 64 to 4096 words the row stream (at one row, at row counts
    that split unevenly over the grid); below and above it the transforms
    run as a one-prime bank on the u32 banks launchers, counted there."""
    p = make_ntt_params(n)
    x = _residues(n + b, [p.q], (b, n))[0]
    xi = _residues(n + b + 1, [p.q], (b, n), band=2 if lazy else 1)[0]
    K.reset_counts()
    for neg in (False, True):
        assert torch.equal(ntt_kernel.ntt_fwd(x, p, negacyclic=neg, lazy=lazy),
                           ref.ntt_fwd_ref(x, p, neg, lazy=lazy)), ("fwd", neg)
        assert torch.equal(ntt_kernel.ntt_inv(xi, p, negacyclic=neg, lazy=lazy),
                           ref.ntt_inv_ref(xi, p, neg, lazy=lazy)), ("inv", neg)
    c = _residues(n + b + 2, [p.q], (b, n))[0]
    kw = dict(q=p.q, mu=p.barrett_mu, lazy=lazy)
    assert torch.equal(dyadic_kernel.dyadic_mul(x, c, **kw),
                       ref.dyadic_mul_ref(x, c, p.q, p.barrett_mu, lazy=lazy))
    assert torch.equal(dyadic_kernel.dyadic_mac(x, c, x, **kw),
                       ref.dyadic_mac_ref(x, c, x, p.q, p.barrett_mu, lazy=lazy))
    counts = K.snapshot()
    banks = ntt_kernel.on_banks(x)
    for name, launches in (("ntt_fwd", 0 if banks else 2), ("ntt_inv", 0 if banks else 2),
                           ("ntt_fwd_banks", 2 if banks else 0),
                           ("ntt_inv_banks", 2 if banks else 0),
                           ("dyadic_mul", 1), ("dyadic_mac", 1)):
        assert counts[name]["launches"] == launches, name


@pytest.mark.parametrize("n", [8192, 1 << 15, 1 << 16, 1 << 17])
def test_single_prime_ops_above_4096_round_trip(cuda, n):
    """ops.ntt / intt on (2, 3, n) rows above 4096 words (one-prime banks)
    give the plain version's words and x back."""
    p = make_ntt_params(n)
    x = _residues(n, [p.q], (2, 3, n))[0]
    y = ops.ntt(x, p)
    assert torch.equal(y, ref.ntt_fwd_ref(x, p, True, lazy=True))
    assert torch.equal(ops.intt(y, p), x)


@pytest.mark.parametrize("n", [2, 32, 64, 128, 4096])
@pytest.mark.parametrize("lazy", [False, True])
def test_single_prime_every_ring_and_an_unaligned_view(cuda, n, lazy):
    """Every ring from 2 words, on aligned rows and on a view one word past
    a 16-byte boundary: the same words as the plain version, the lazy
    inverse on [0, 2q) inputs included.  Rings below the row stream's 64
    words and the unaligned views run as a one-prime bank (the banks' row
    body loads and stores its own words), counted there."""
    p = make_ntt_params(n)
    flat = _residues(n + 5, [p.q], (7 * n + 1,))[0]
    flati = _residues(n + 6, [p.q], (7 * n + 1,), band=2 if lazy else 1)[0]
    K.reset_counts()
    for x, xi in ((flat[:7 * n].view(7, n), flati[:7 * n].view(7, n)),
                  (flat[1:].view(7, n), flati[1:].view(7, n))):
        for neg in (False, True):
            assert torch.equal(ntt_kernel.ntt_fwd(x, p, negacyclic=neg, lazy=lazy),
                               ref.ntt_fwd_ref(x, p, neg, lazy=lazy)), ("fwd", neg)
            assert torch.equal(ntt_kernel.ntt_inv(xi, p, negacyclic=neg, lazy=lazy),
                               ref.ntt_inv_ref(xi, p, neg, lazy=lazy)), ("inv", neg)
    c = K.snapshot()
    stream = 2 if n >= ntt_kernel.MIN_N_STREAM else 0   # the aligned rows' two calls
    assert c["ntt_fwd"]["launches"] == c["ntt_inv"]["launches"] == stream
    assert c["ntt_fwd_banks"]["launches"] == c["ntt_inv_banks"]["launches"] == 4 - stream


def test_single_prime_ops_round_trip_and_odd_words(cuda):
    """ops over (3, 5, 128) rows, and the Barrett kernels' one-word path
    (a word count that is not a multiple of 4, an unaligned view)."""
    p = make_ntt_params(128)
    x = _residues(7, [p.q], (3, 5, 128))[0]
    y = ops.ntt(x, p)
    assert torch.equal(y, ref.ntt_fwd_ref(x, p, True, lazy=True))
    assert torch.equal(ops.intt(y, p), x)
    flat = x.reshape(-1)
    for a in (flat[:13], flat[1:14]):
        b = a.flip(0).contiguous()
        assert torch.equal(dyadic_kernel.dyadic_mul(a, b, q=p.q, mu=p.barrett_mu, lazy=True),
                           ref.dyadic_mul_ref(a, b, p.q, p.barrett_mu, lazy=True))
        assert torch.equal(dyadic_kernel.dyadic_mac(b, a, b, q=p.q, mu=p.barrett_mu, lazy=True),
                           ref.dyadic_mac_ref(b, a, b, p.q, p.barrett_mu, lazy=True))


# ------------------------------------------------ EvalPlan's CUDA graphs

def _graphed(device, n=1 << 10, seed=5):
    """A context on the card with keys for rotations 1-3, conjugation and
    an 8 x 4 matvec, two ciphertexts, and the plan's eager twin (the same
    tables and keys, every program run eagerly)."""
    import copy
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    ctx = CkksContext(n=n, levels=2, scale_bits=28, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    M = linalg.PtMatrix.encode(ctx, rng.uniform(-1, 1, (8, 4)) / 4)
    plan = ctx.plan()
    plan.prepare(rotations=(1, 2, 3), conjugate=True, warm_jit=False, matvecs=(M,))
    cts = [ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.slots))) for _ in range(3)]
    eager = copy.copy(plan)
    eager._graphs = None
    return ctx, plan, eager, M, cts


def _programs(plan, M, cts):
    """name -> answers of each graphed program (and the matvec composite)."""
    from repro_torch.fhe import linalg
    a, b, c = cts
    return {
        "multiply": [plan.multiply(a, b)],
        "rescale": [plan.rescale(a)],
        "galois_ks": [plan.rotate(a, 1), plan.conjugate(b)],
        "multiply_many": plan.multiply_many(cts, [b, c, a]),
        "rescale_many": plan.rescale_many(cts),
        "galois_ks_many uniform": plan.rotate_many(cts, [2, 2, 2]),
        "galois_ks_many mixed": plan.rotate_many(cts, [1, 2, 3]),
        "hoisted_galois": plan.rotate_hoisted(a, [1, 2, 3]),
        "matvec (plain_mac, accumulate)": [linalg.matvec(plan, M, a)],
    }


def _same_cts(xs, ys):
    return len(xs) == len(ys) and all(
        torch.equal(x.c0.data, y.c0.data) and torch.equal(x.c1.data, y.c1.data)
        and x.scale == y.scale and x.primes == y.primes for x, y in zip(xs, ys))


@pytest.mark.parametrize("logn", [10, 14])
def test_graph_replays_equal_the_eager_programs(cuda, logn):
    """Every graphed program, on its capturing call and on replays with
    other inputs, equals the same program run eagerly on the card."""
    from repro_torch.fhe.evalplan import EvalPlan
    ctx, plan, eager, M, cts = _graphed(cuda, 1 << logn)
    before = EvalPlan.trace_count()
    for round_ in range(3):
        got, want = _programs(plan, M, cts), _programs(eager, M, cts)
        for name in want:
            assert _same_cts(got[name], want[name]), (round_, name)
        cts = [x for x in got["multiply_many"]]         # other inputs, same shapes
    assert EvalPlan.trace_count() - before == len(plan._graphs) >= 9
    assert eager._graphs is None


def test_fresh_traces_zero_after_a_covering_prepare(cuda):
    """An engine's drain on an unprepared plan captures graphs inside its
    latency window (fresh_traces > 0); after a prepare that covers both
    serving bases, the engine's group sizes and the matvec pack it
    captures none, and every answer equals the eager programs'."""
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    from repro_torch.fhe.serve import CkksServeEngine, synthetic_trace
    ctx = CkksContext(n=1 << 10, levels=2, scale_bits=28, seed=9, device=cuda)
    M = linalg.PtMatrix.encode(ctx, np.random.default_rng(9).uniform(-1, 1, (8, 4)) / 4)
    reqs, _ = synthetic_trace(ctx, 16, seed=9, matrix=M)
    engine = CkksServeEngine(ctx.plan(), batch_tile=4, max_batch=8)
    cold = engine.run_async(reqs)
    assert engine.stats["fresh_traces"] > 0 and not engine.stats["failed"]
    fresh = CkksContext(n=1 << 10, levels=2, scale_bits=28, seed=9, device=cuda)
    M2 = linalg.PtMatrix.encode(fresh, np.random.default_rng(9).uniform(-1, 1, (8, 4)) / 4)
    plan = fresh.plan()
    for basis in (fresh.qs, fresh.qs[:-1]):
        plan.prepare(basis=basis, rotations=(1, 2), conjugate=True,
                     batch_sizes=(4, 8), matvecs=(M2,) if basis == fresh.qs else ())
    reqs2, _ = synthetic_trace(fresh, 16, seed=9, matrix=M2)
    engine = CkksServeEngine(plan, batch_tile=4, max_batch=8)
    for drain in (engine.run, engine.run_async):
        out = drain(reqs2)
        assert engine.stats["fresh_traces"] == 0 and not engine.stats["failed"]
    assert set(out) == set(cold)


def test_counts_advance_on_replay(cuda):
    """A replay adds the launches its capture recorded, so COUNTS read the
    kernels the card ran: a graphed multiply + rescale counts what the
    eager one counts, call after call, and no plain version runs."""
    _, plan, eager, _, (a, b, _) = _graphed(cuda)
    plan.rescale(plan.multiply(a, b))                    # capture
    K.reset_counts()
    eager.rescale(eager.multiply(a, b))
    once = K.snapshot()
    assert once["ntt_fwd_banks"]["launches"] > 0
    for calls in (1, 2, 3):
        K.reset_counts()
        for _ in range(calls):
            plan.rescale(plan.multiply(a, b))
        got = K.snapshot()
        for name, c in once.items():
            assert got[name]["launches"] == calls * c["launches"], (calls, name)
            assert got[name]["plain_calls"] == 0


def test_batch_key_eviction_under_a_live_graph(cuda):
    """The mixed-batch key stacks are inputs copied into the graph, so
    evicting their cache entry (and restacking it later) changes no
    answer: patterns A, B, A again through one captured signature."""
    _, plan, eager, _, cts = _graphed(cuda)
    plan._BATCH_KEY_CACHE_MAX = 1
    eager._batch_keys = {}
    for amounts in ([1, 2, 3], [3, 1, 2], [1, 2, 3], [2, 3, 1]):
        got = plan.rotate_many(cts, amounts)
        assert len(plan._batch_keys) == 1
        assert _same_cts(got, eager.rotate_many(cts, amounts)), amounts
    mixed = [sig for sig in plan._graphs if sig[0] == "galois_ks_many"]
    assert len(mixed) == 1


# ------------------------------------------------ the "b" mesh on the card

def _sharded_programs(plan, M, cts):
    """The batched programs at sizes a 2-shard mesh pads (3 -> 4, R = 3 -> 4)
    and the matvec composite."""
    from repro_torch.fhe import linalg
    a, b, c = cts
    prod = plan.multiply_many(cts, [b, c, a])
    return {
        "multiply_many": prod,
        "rescale_many": plan.rescale_many(prod),
        "rotate_many mixed": plan.rotate_many(cts, [1, 2, 3]),
        "conjugate_many": plan.conjugate_many(cts),
        "rotate_hoisted": plan.rotate_hoisted(a, [1, 2, 3]),
        "matvec": [linalg.matvec(plan, M, a)],
    }


@pytest.mark.parametrize("logn", [10, 14])
@pytest.mark.parametrize("copies", [1, 2])
def test_mesh_on_the_card_equals_the_unsharded_plan(cuda, logn, copies):
    """A mesh of the card once and twice: every batched program, the
    hoisted set and the matvec equal the unsharded plan's words, through
    the sharded graphs (captured once per shape, replayed by both shards),
    and every kernel of the rotation path launched."""
    from repro_torch.fhe.evalplan import EvalPlan
    from repro_torch.mesh import make_mesh
    ctx, plan, _, M, cts = _graphed(cuda, 1 << logn)
    sharded = EvalPlan(ctx, mesh=make_mesh([cuda] * copies))
    assert sharded.mesh_devices == copies and sharded._shards == (ctx.device,) * copies
    want = _sharded_programs(plan, M, cts)
    before = EvalPlan.trace_count()
    K.reset_counts()
    for round_ in range(2):
        got = _sharded_programs(sharded, M, cts)
        for name in want:
            assert _same_cts(got[name], want[name]), (round_, name)
    assert EvalPlan.trace_count() - before == len(sharded._graphs)
    counts = K.snapshot()
    for name in ("ntt_fwd_banks", "ntt_inv_banks", "dyadic_inner_banks", "galois_banks",
                 "galois_banks_multi", "galois_digits"):
        assert counts[name]["launches"] > 0 and counts[name]["plain_calls"] == 0, name


def test_mesh_over_two_cards_equals_the_unsharded_plan(cuda):
    """Shards on two distinct cards (each its own graphs, pool and stream,
    outputs copied back to the plan's card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA devices, found {torch.cuda.device_count()}")
    from repro_torch.fhe.evalplan import EvalPlan
    from repro_torch.mesh import make_mesh
    ctx, plan, _, M, cts = _graphed(cuda)
    sharded = EvalPlan(ctx, mesh=make_mesh(["cuda:0", "cuda:1"]))
    want = _sharded_programs(plan, M, cts)
    got = _sharded_programs(sharded, M, cts)
    for name in want:
        assert _same_cts(got[name], want[name]), name
    assert {sig[2] for sig in sharded._graphs} == {str(ctx.device), "cuda:1"}


def test_fourstep_sharded_on_the_card(cuda):
    from repro_torch.core import fourstep as fs
    from repro_torch.mesh import make_mesh
    fsp = fs.make_fourstep_params(128, 128)
    a = _residues(3, [fsp.q], (128 * 128,))[0]
    for neg in (False, True):
        want = fs.fourstep_ntt(a, fsp, negacyclic=neg)
        for copies in (1, 2, 4):
            D = fs.fourstep_ntt_sharded(a.view(128, 128), fsp, make_mesh([cuda] * copies),
                                        axis="b", negacyclic=neg)
            assert torch.equal(D.t().reshape(-1), want), (neg, copies)


def test_serve_batch_is_measured_on_the_card(cuda, monkeypatch, tmp_path):
    """The tuner's runner on the card: every candidate timed, the sidecar
    written and read back, and a resolve inside a graph capture does not
    measure."""
    import importlib
    from repro_torch import obs
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "tiles.json"))
    autotune.clear()
    tile = autotune.ensure("serve_batch", 3, 1 << 10, 8, shards=2)
    key = f"{torch.cuda.get_device_name(cuda)}|serve_batch|3|1024|4|uint32"
    ev = autotune.table()["evidence"][key]
    assert ev["source"] == "measured" and set(ev["candidates"]) == {"1", "2", "4"}
    importlib.reload(autotune)
    assert autotune.resolve_tile("serve_batch", 3, 1 << 10, 8, shards=2) == tile
    assert autotune.table()["evidence"][key]["source"] == "disk"
    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "1")
    obs.enable()
    obs.reset()
    try:
        x = torch.zeros(4, device=cuda)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            inside = autotune.resolve_tile("serve_batch", 3, 1 << 10, 64)
            x += 1
        counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert inside == autotune.DEFAULT_TILE
    assert counters.get("autotune.measurements", 0) == 0
    assert counters["autotune.resolve.default"] == 1
