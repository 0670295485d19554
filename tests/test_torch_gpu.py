"""The port's CUDA kernels against their plain PyTorch versions on the
card, for every ring size the NTT kernels take (2^4 .. 2^12), both key
layouts of the digit MAC, ragged batches, and the Galois gathers in both
bit orders (shared and per-batch rows, digits shared and not).  Marked ``gpu``: they
skip where no CUDA device is present.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.core.params import galois_eval_perm
from repro_torch.kernels import dyadic_kernel, galois_kernel, ntt_kernel, ref

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


@pytest.mark.parametrize("logn", range(4, 13))
@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_banks_kernels_equal_plain(cuda, logn, lazy):
    n = 1 << logn
    primes = rns.make_primes(n, 3)
    t = TB.build_table_pack(primes, n, cuda)
    x = _residues(logn, primes, (7, n), band=2 if lazy else 1)
    xr = _residues(logn + 100, primes, (7, n))
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


@pytest.mark.parametrize("lazy", [False, True])
def test_twiddle_kernel_equal_plain(cuda, lazy):
    n = 1 << 14
    primes = rns.make_primes(n, 3)
    fp = TB.build_fourstep_pack(primes, n, cuda)
    x = _residues(3, primes, (5, n), band=2)
    got = ntt_kernel.twiddle_mul_banks(x, fp["qs"], fp["tw"], fp["twp"], lazy=lazy)
    assert torch.equal(got, ref.twiddle_mul_banks_ref(x, fp["qs"], fp["tw"], fp["twp"],
                                                      lazy=lazy))


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


def test_oversized_gather_row_is_refused(cuda):
    n = 1 << 16
    x = torch.zeros((1, 1, n), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        galois_kernel.galois_banks(x, torch.zeros(n, dtype=torch.int32, device=cuda))


def test_unaligned_gather_row_is_refused(cuda):
    n = 64
    words = torch.zeros(2 * n + 1, dtype=torch.int32, device=cuda)
    x = words[1:n + 1].view(1, 1, n)
    with pytest.raises(ValueError, match="16-byte boundary"):
        galois_kernel.galois_banks(x, torch.arange(n, dtype=torch.int32, device=cuda))
