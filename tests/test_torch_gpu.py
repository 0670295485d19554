"""The port's CUDA kernels against their plain PyTorch versions on the
card, for every ring size the NTT kernels take (2^4 .. 2^12), both key
layouts of the digit MAC, and ragged batches.  Marked ``gpu``: they
skip where no CUDA device is present.  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref

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
