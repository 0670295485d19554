"""The port's op counter (``runtime.op_cost``) on ``meta`` tensors, the
counterpart of the reference's ``tests/test_hlo_cost.py``: products,
loops, bytes and collectives against known counts, and the kernel
wrappers' meta branches (the same checks as their CUDA branches, one
recorded launch each, CPU tensors still on the plain path), with a
small meta key switch recording the launches the CPU run counts."""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.convert import from_reference
from repro_torch.core.params import make_ntt_params
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.kernels import (basis_kernel, build, dyadic_kernel, galois_kernel,
                                 keccak_kernel, mldsa_kernel, ntt_kernel)
from repro_torch.mesh import all_gather, make_mesh, psum
from repro_torch.runtime import op_cost, roofline


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_single_matmul_flops():
    x = _meta(1024, 1024, dtype=torch.bfloat16)
    with op_cost.OpCounter() as c:
        x @ x
    assert c.cost.flops == 2 * 1024**3


def test_layer_loop_counts_every_iteration():
    """The reference's scan-over-layers case: a Python loop of 10
    products is counted 10 times (eager loops dispatch each iteration)."""
    x, ws = _meta(512, 512, dtype=torch.bfloat16), _meta(10, 512, 512, dtype=torch.bfloat16)
    with op_cost.OpCounter() as c:
        for i in range(10):
            x = x @ ws[i]
    assert c.cost.flops == 10 * 2 * 512**3


def test_nested_loop():
    x, ws = _meta(256, 256, dtype=torch.bfloat16), _meta(4, 3, 256, 256, dtype=torch.bfloat16)
    with op_cost.OpCounter() as c:
        for i in range(4):
            for j in range(3):
                x = x @ ws[i, j]
    assert c.cost.flops == 12 * 2 * 256**3


def test_bytes_of_an_elementwise_op():
    a = _meta(4096, 4096)
    with op_cost.OpCounter() as c:
        a + 1.0
    assert c.cost.bytes == 2 * 4096 * 4096 * 4          # read + write
    assert c.cost.flops == 4096 * 4096                  # one per element


def test_views_move_nothing_and_reads_are_tracked():
    a, b = _meta(64, 64), _meta(64, 64)
    with op_cost.OpCounter({"a": a, "b": b}) as c:
        v = a[:32].t()
        v.contiguous()
        b[0]
    assert c.cost.bytes == 2 * 32 * 64 * 4              # the copy only
    assert c.read == {"a"}                              # b only viewed


def test_live_bytes_follow_the_storage():
    """A reshape that copies returns an ``_unsafe_view`` of its copy: the
    copy's storage stays live while the view does, though the tensor it
    was made as is gone; a tensor made before the pass is not the
    pass's."""
    a = _meta(64, 128)
    size = 64 * 128 * 4
    with op_cost.OpCounter() as c:
        y = a.t().reshape(-1)           # clone + _unsafe_view
        z = y + 1
        assert c.live == 2 * size
        del y
        assert c.live == size
        del z
    assert (c.live, c.peak) == (0, 2 * size)


def test_collectives_in_loop_counted():
    """An all_gather inside a 6-step loop on a 4-way mesh of one device
    repeated: 6 collectives, each with the ring model's traffic."""
    mesh = make_mesh(["meta"] * 4)
    vals = [_meta(256, 64) for _ in range(4)]
    with op_cost.OpCounter() as c:
        for _ in range(6):
            out = all_gather(vals, mesh, "b", dim=1)
        psum(vals, mesh, "b")
    per = 256 * 256 * 4                                 # one device's gathered block
    assert out[0].shape == (256, 256)
    assert c.cost.coll_counts == {"all-gather": 6, "all-reduce": 1}
    assert c.cost.coll_bytes["all-gather"] == 6 * per
    assert c.cost.coll_traffic == pytest.approx(
        6 * per * 3 / 4 + roofline.ring_traffic("all-reduce", 256 * 64 * 4, 4))


def test_fourstep_exchange_is_recorded():
    """The sharded four-step's reorder network (the reference's one
    ``all_to_all``) records one all-to-all of a shard's block."""
    from repro_torch.core import fourstep as fs
    fsp = fs.make_fourstep_params(16, 16)
    a = torch.zeros((16, 16), dtype=torch.int32)
    with op_cost.OpCounter() as c:
        fs.fourstep_ntt_sharded(a, fsp, make_mesh(["cpu"] * 4, ("model",)))
    assert c.cost.coll_counts == {"all-to-all": 1}
    assert c.cost.coll_bytes == {"all-to-all": 16 * 4 * 4}
    assert c.cost.coll_traffic == 16 * 4 * 4 * 3 / 4


def test_repeated_call_counts_forward_and_backward():
    """A shard branch run once for 5 identical shards counts its forward
    and its backward 5 times."""
    w = _meta(64, 64).requires_grad_()
    x = _meta(8, 64)
    with op_cost.OpCounter() as once:
        (x @ w).sum().backward()
    w.grad = None
    with op_cost.OpCounter() as five:
        y, = op_cost.repeated_call(5, lambda x, w: (x @ w,), x, w)
        y.sum().backward()
    assert w.grad.shape == w.shape
    assert once.cost.flops == 2 * 2 * 8 * 64 * 64       # x @ w and x.T @ dy
    assert five.cost.flops == 5 * once.cost.flops


# ------------------------------------------------- kernel meta branches

N = 64
PRIMES = tuple(rns.make_primes(N, 3))
FOURSTEP_N = 1024     # the four-step kernels' smallest ring (32 x 32)


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: the wrapper's kernel
    path without a card."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        plain = lambda a: a.as_subclass(torch.Tensor) if isinstance(a, cls) else a
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*map(plain, args), **{k: plain(v) for k, v in (kwargs or {}).items()})
            return out.as_subclass(cls) if type(out) is torch.Tensor else out

    @property
    def device(self):
        return torch.device("cuda", 0)


class _NoLaunch:
    def __getattr__(self, fn):
        raise AssertionError(f"{fn} reached on a tensor the kernel refuses")


FS_PRIMES = tuple(rns.make_primes(FOURSTEP_N, 3))


def _tree_to(tree: dict, as_, device) -> dict:
    return {key: (_tree_to(v, as_, device) if isinstance(v, dict) else as_(v.to(device)))
            for key, v in tree.items()}


def _calls(device, bad: bool, fake=None):
    """(kernel, call) of every wrapper on meta-sized tensors of ``device``;
    ``bad`` gives the main input a wrong last dim."""
    as_ = (lambda v: v) if fake is None else (lambda v: v.as_subclass(fake))
    z = lambda *shape, dt=torch.int32: as_(torch.zeros(shape, dtype=dt, device=device))
    t = {k: as_(v.to(device)) for k, v in TB.build_table_pack(PRIMES, N, "cpu").items()}
    k = len(PRIMES)
    n = N + 2 if bad else N
    x, ext, evk = z(k, 2, n), z(2, k, 2, n), z(2, k, N)
    row, rows = z(N), z(2, N)
    a16, g16 = z(1, 2, n, dt=torch.int16), z(1, N // 2, dt=torch.int16)
    q16 = z(1, dt=torch.int16)
    p = make_ntt_params(N)
    fl = dict(negacyclic=True, lazy=True, reduce_out=True)
    conv = from_reference(TB.conv_table_np(
        [list(enumerate(PRIMES[:2])), [(2, PRIMES[2])]], PRIMES), "cpu")
    fs = _tree_to(TB.build_fourstep_pack(FS_PRIMES, FOURSTEP_N, "cpu"), as_, device)
    return {
        "ntt_fwd_banks": lambda: ntt_kernel.ntt_fwd_banks(
            x, t["qs"], t["tw"], t["twp"], t["psi"], t["psip"], **fl),
        "ntt_inv_banks": lambda: ntt_kernel.ntt_inv_banks(
            x, t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"],
            t["ipsinp"], **fl),
        "twiddle_mul_banks": lambda: ntt_kernel.twiddle_mul_banks(
            x, t["qs"], t["psi"], t["psip"], lazy=True),
        "dyadic_inner_banks": lambda: dyadic_kernel.dyadic_inner_banks(
            ext, evk, t["qs"], t["mu"], lazy=True),
        "galois_banks": lambda: galois_kernel.galois_banks(x, row),
        "galois_banks_multi": lambda: galois_kernel.galois_banks_multi(x, rows),
        "galois_digits": lambda: galois_kernel.galois_digits(ext, rows, shared=False),
        "dyadic_basemul_banks": lambda: dyadic_kernel.dyadic_basemul_banks(
            a16, a16, q16, q16, g16, g16, lazy=True),
        "ntt_fwd": lambda: ntt_kernel.ntt_fwd(z(2, n), p, negacyclic=True, lazy=True),
        "ntt_inv": lambda: ntt_kernel.ntt_inv(z(2, n), p, negacyclic=True, lazy=True),
        "dyadic_mul": lambda: dyadic_kernel.dyadic_mul(
            z(2, N), z(2, n), q=p.q, mu=p.barrett_mu, lazy=True),
        "dyadic_mac": lambda: dyadic_kernel.dyadic_mac(
            z(2, N), z(2, N), z(2, n), q=p.q, mu=p.barrett_mu, lazy=True),
        # the k digits of x onto one prime; a wrong row length comes with a
        # source column of the wrong length
        "extend_centered": lambda: basis_kernel.extend_centered(
            x, z(k + 1) if bad else t["qs"], t["qs"][:1]),
        "mod_down_tail": lambda: basis_kernel.mod_down_tail(
            x, z(k, 2, N), t["qs"], t["qs"], t["qs"], batch_leading=False),
        # two digits of the k rows of x onto every prime; a wrong table
        # comes with a digit count column of the wrong length
        "base_conv": lambda: basis_kernel.base_conv(x, {
            name: (as_(v.to(device)[:1]) if bad and name == "cnt" else as_(v.to(device)))
            for name, v in conv.items()}),
        # rows of the 32 x 32 split, x batch-leading (strided over its
        # first two axes); a wrong row length is refused
        "ntt_fourstep_banks": lambda: ntt_kernel.ntt_fourstep_banks(
            z(2, k, FOURSTEP_N + (2 if bad else 0)).transpose(0, 1), fs,
            negacyclic=True, lazy=True),
        "intt_fourstep_banks": lambda: ntt_kernel.intt_fourstep_banks(
            z(2, k, FOURSTEP_N + (2 if bad else 0)).transpose(0, 1), fs,
            negacyclic=True, lazy=True),
        # two byte rows; a second part of another row count is refused
        "keccak_hash": lambda: keccak_kernel.keccak_hash(
            z(2, 1184, dt=torch.uint8), z(3 if bad else 2, 32, dt=torch.uint8),
            rate=136, suffix=0x06, out_len=32),
        # ML-DSA's codec on its ring of 256 words; a wrong row length refused
        "mldsa_w1_encode": lambda: mldsa_kernel.w1_encode(z(6, 2, 256 + (2 if bad else 0))),
        "mldsa_check": lambda: mldsa_kernel.sign_check(
            z(2, 5, 256 + (2 if bad else 0)), z(6, 2, 256), z(17, 2, 256), z(2, dt=torch.bool)),
    }


KERNELS = list(_calls("meta", False))


@pytest.mark.parametrize("name", KERNELS)
def test_meta_branch_refuses_what_the_kernel_refuses(monkeypatch, name):
    """A wrong shape raises on meta with the CUDA branch's own message."""
    monkeypatch.setattr(build, "load", lambda lib: _NoLaunch())
    with pytest.raises(ValueError) as on_card:
        _calls("meta", True, _FakeCuda)[name]()
    with pytest.raises(ValueError) as on_meta:
        _calls("meta", True)[name]()
    assert str(on_meta.value) == str(on_card.value)


@pytest.mark.parametrize("name", KERNELS)
def test_meta_branch_records_one_launch(monkeypatch, name):
    """On meta: the output's shape and dtype, one launch in the counter,
    none in ``kernels.COUNTS``, no library loaded; its bytes at least the
    output written and the main input read."""
    monkeypatch.setattr(build, "load", lambda lib: _NoLaunch())
    K.reset_counts()
    with op_cost.OpCounter() as c:
        out = _calls("meta", False)[name]()
    assert out.device.type == "meta"
    assert c.kernels == {name: 1}
    assert c.cost.bytes >= 2 * out.numel() * out.element_size()
    assert all(v == {"launches": 0, "plain_calls": 0} for v in K.snapshot().values())


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensor_stays_on_the_plain_path(name):
    K.reset_counts()
    with op_cost.OpCounter() as c:
        out = _calls("cpu", False)[name]()
    assert out.device.type == "cpu"
    assert c.kernels == {}
    assert K.snapshot()[name]["plain_calls"] == 1


@pytest.mark.parametrize("fourstep", [False, True], ids=["banks", "fourstep"])
def test_meta_keyswitch_records_the_cpu_runs_launches(fourstep):
    """A meta ``batched_keyswitch`` (k = 3 + 1 primes, B = 2, n = 64)
    records, kernel by kernel, the launches the CPU run's plain versions
    count; on the four-step route with a FourStepPack too (n = 1024, the
    smallest ring of the four-step kernels), whose transforms are
    ``ntt_fourstep_banks`` and ``intt_fourstep_banks``."""
    k, b = 3, 2
    n = FOURSTEP_N if fourstep else N
    primes = tuple(rns.make_primes(n, k + 1))
    rng = np.random.default_rng(7)
    t = TB.build_table_pack(primes, n, "cpu")
    fsp = TB.build_fourstep_pack(primes, n, "cpu") if fourstep else None
    d2 = torch.from_numpy(np.stack([rng.integers(0, q, (b, n)) for q in primes[:k]])
                          .astype(np.int32))
    evk = torch.from_numpy(rng.integers(0, primes[0], (k, k + 1, n)).astype(np.int32))
    K.reset_counts()
    TB.batched_keyswitch(d2, evk, evk, t, fsp=fsp)
    cpu = {name: v["plain_calls"] for name, v in K.snapshot().items() if v["plain_calls"]}
    to_meta = lambda tree: {key: (to_meta(v) if isinstance(v, dict) else v.to("meta"))
                            for key, v in tree.items()}
    with op_cost.OpCounter() as c:
        ks0, ks1 = TB.batched_keyswitch(d2.to("meta"), evk.to("meta"), evk.to("meta"),
                                        to_meta(t), fsp=fsp and to_meta(fsp))
    assert ks0.shape == ks1.shape == (k, b, n)
    assert c.kernels == cpu
    fwd, inv = (("ntt_fourstep_banks", "intt_fourstep_banks") if fourstep
                else ("ntt_fwd_banks", "ntt_inv_banks"))
    assert set(cpu) >= {fwd, inv, "dyadic_inner_banks"}
