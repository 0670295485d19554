"""The port's serving engine (``repro_torch.fhe.serve``) on the CPU: the
same ``synthetic_trace`` through the port's and the reference's engines
gives the same answers bit for bit and the same ``stats`` (sync and
async, CKKS and matvec requests at two levels); the reference's own
serve cases (tests/test_serve_fhe.py, test_serve_async.py) on the port;
a CPU plan captures no graph; no scheme program
builds a tensor from host data (a CUDA graph could not capture it); and
a fault of the card inside a served request raises out of the drain
instead of failing that request."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fhe import linalg as RL
from repro.fhe import serve as RS
from repro.fhe.ckks import CkksContext as RefContext

from repro_torch import kernels as K
from repro_torch.convert import tensor_to_u32
from repro_torch.fhe import evalplan as TEP
from repro_torch.fhe import linalg
from repro_torch.fhe import serve
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import Ciphertext
from repro_torch.fhe.rns import RnsPoly
from repro_torch.fhe.serve import CkksServeEngine, FheRequest, synthetic_trace
from repro_torch.kernels import build, galois_kernel

torch.set_num_threads(2)

N, LEVELS, SCALE_BITS = 256, 2, 26
TIMING = ("latency_us", "wall_s", "fresh_traces")


def _eq(a, b) -> bool:
    """Two of the port's ciphertexts: residues, scale and basis equal."""
    return (torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)
            and a.scale == b.scale and a.primes == b.primes)


def _ref_eq(r, p) -> bool:
    """A reference ciphertext and a port one: the same integers."""
    return (np.array_equal(np.asarray(r.c0.data), tensor_to_u32(p.c0.data))
            and np.array_equal(np.asarray(r.c1.data), tensor_to_u32(p.c1.data))
            and r.scale == p.scale and r.primes == p.primes)


def _ctx(seed=71):
    return CkksContext(n=N, levels=LEVELS, scale_bits=SCALE_BITS, seed=seed, device="cpu")


# --------------------------------------------- against the reference engine

def _drains(Context, Linalg, Serve, kw):
    """A context, a matvec pack and a mixed trace of CKKS and matvec
    requests at two levels, drained by ``run`` and then ``run_async``:
    (answers, stats) of each."""
    ctx = Context(n=N, levels=LEVELS, scale_bits=SCALE_BITS, seed=81, **kw)
    M = Linalg.PtMatrix.encode(ctx, np.random.default_rng(82).uniform(-0.5, 0.5, (8, 4)))
    reqs, _ = Serve.synthetic_trace(ctx, 10, seed=5, matrix=M)
    return drain_both(Serve.CkksServeEngine(ctx.plan(), batch_tile=8), reqs)


def drain_both(engine, reqs):
    """(answers, stats) of ``run`` and then ``run_async`` on ``reqs``."""
    out = []
    for drain in (engine.run, engine.run_async):
        answers = drain(list(reqs))
        out.append((answers, dict(engine.stats)))
    return out


@pytest.fixture(scope="module")
def both_engines():
    return (_drains(RefContext, RL, RS, {}),
            _drains(CkksContext, linalg, serve, {"device": "cpu"}))


@pytest.mark.parametrize("drain", [0, 1], ids=["run", "run_async"])
def test_engine_equals_reference_on_synthetic_trace(both_engines, drain):
    (ref_out, ref_stats), (out, stats) = both_engines[0][drain], both_engines[1][drain]
    assert set(out) == set(ref_out) and len(out) == 10
    for rid in ref_out:
        assert _ref_eq(ref_out[rid], out[rid]), rid
    assert_same_stats(stats, ref_stats)
    assert {"matvec@L2", "galois@L1"} <= set(stats["groups"])


def assert_same_stats(stats, ref_stats):
    """Equal keys, and equal values but for the timings and the count of
    captures (the reference's compiles)."""
    assert set(stats) == set(ref_stats)
    for key in set(stats) - set(TIMING):
        assert stats[key] == ref_stats[key], key
    assert set(stats["latency_us"]) == set(ref_stats["latency_us"])


def test_async_answers_equal_sync(both_engines):
    (sync, _), (asy, _) = both_engines[1]
    assert set(sync) == set(asy)
    assert all(_eq(a, asy[rid]) for rid, a in sync.items())


# ------------------------------------------- the reference's serve cases

CTX = _ctx()
RNG = np.random.default_rng(72)


def _ct():
    z = RNG.uniform(-1, 1, CTX.slots) + 1j * RNG.uniform(-1, 1, CTX.slots)
    return CTX.encrypt(CTX.encode(z))


def _matrix(seed=77):
    return linalg.PtMatrix.encode(CTX, np.random.default_rng(seed).uniform(-0.5, 0.5, (8, 4)))


def test_engine_bit_exact_and_groups():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=4)
    reqs = [FheRequest(0, "multiply", _ct(), other=_ct()),
            FheRequest(1, "rotate", _ct(), r=1),
            FheRequest(2, "rotate", _ct(), r=3),
            FheRequest(3, "conjugate", _ct()),
            FheRequest(4, "multiply", _ct(), other=_ct()),
            FheRequest(5, "rotate", _ct(), r=0)]
    out = engine.run(reqs)
    assert set(out) == set(range(6))
    assert (engine.stats["dispatches"], engine.stats["identity"],
            engine.stats["batched_ops"], engine.stats["padded"]) == (2, 1, 5, 3)
    single = {0: plan.multiply(reqs[0].ct, reqs[0].other), 1: plan.rotate(reqs[1].ct, 1),
              2: plan.rotate(reqs[2].ct, 3), 3: plan.conjugate(reqs[3].ct),
              4: plan.multiply(reqs[4].ct, reqs[4].other), 5: plan.rotate(reqs[5].ct, 0)}
    assert all(_eq(out[r], single[r]) for r in single)


def test_engine_splits_mixed_bases():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=2)
    cts = [_ct(), _ct()] + [plan.rescale(ct) for ct in (_ct(), _ct())]
    out = engine.run([FheRequest(i, "rescale", ct) for i, ct in enumerate(cts)])
    assert engine.stats["dispatches"] == 2
    assert sorted(engine.stats["groups"]) == ["rescale@L1", "rescale@L2"]
    assert all(_eq(out[i], plan.rescale(ct)) for i, ct in enumerate(cts))


def test_bad_request_fails_alone():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=2)
    good, dropped = _ct(), plan.rescale(_ct())
    bottom = dropped
    while len(bottom.primes) > 1:
        bottom = plan.rescale(bottom)
    out = engine.run([FheRequest(0, "multiply", _ct(), other=dropped),
                      FheRequest(1, "rescale", bottom),
                      FheRequest(2, "rotate", good, r=1)])
    assert set(out) == {2} and set(engine.stats["failed"]) == {0, 1}
    assert "bases differ" in engine.stats["failed"][0]
    assert "prime chain exhausted" in engine.stats["failed"][1]
    assert _eq(out[2], plan.rotate(good, 1))


def test_engine_mixed_matvec_and_rotate_queue():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=4)
    rng = np.random.default_rng(73)
    W = rng.uniform(-0.5, 0.5, (8, 4))
    M = linalg.PtMatrix.encode(CTX, W)
    xs = [rng.uniform(-1, 1, 8) for _ in range(2)]
    vcts = [CTX.encrypt(linalg.encode_vector(CTX, x, 4)) for x in xs]
    rot_ct = _ct()
    out = engine.run([FheRequest(0, "matvec", vcts[0], matrix=M),
                      FheRequest(1, "rotate", rot_ct, r=2),
                      FheRequest(2, "matvec", vcts[1], matrix=M),
                      FheRequest(3, "conjugate", rot_ct)])
    stats = engine.stats
    assert set(out) == set(range(4))
    assert sorted(stats["groups"]) == ["galois@L2", "matvec@L2"]
    assert (stats["dispatches"], stats["padded"], stats["program_dispatches"],
            stats["key_switches"], stats["decomposes"], stats["hoisted_reuse"]) == \
        (2, 2, 5, 12, 10, 2)
    for rid, vct in ((0, vcts[0]), (2, vcts[1])):
        assert _eq(out[rid], linalg.matvec(plan, M, vct))
    assert _eq(out[1], plan.rotate(rot_ct, 2)) and _eq(out[3], plan.conjugate(rot_ct))
    np.testing.assert_allclose(CTX.decrypt_decode(out[0]).real[:4], xs[0] @ W, atol=1e-2)
    M0 = linalg.PtMatrix.encode(CTX, np.zeros((4, 4)))
    out2 = engine.run([FheRequest(0, "matvec", plan.rescale(vcts[0]), matrix=M),
                       FheRequest(1, "rotate", rot_ct, r=1),
                       FheRequest(2, "matvec", vcts[0], matrix=M0)])
    assert set(out2) == {1}
    assert "valid at exactly one basis" in engine.stats["failed"][0]
    assert "no nonzero diagonals" in engine.stats["failed"][2]
    assert engine.stats["dispatches"] == 1 and list(engine.stats["groups"]) == ["galois@L2"]


def test_poisoned_matvec_fails_alone():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=2)
    rng = np.random.default_rng(74)
    M = linalg.PtMatrix.encode(CTX, rng.uniform(-0.5, 0.5, (8, 4)))
    poisoned = dataclasses.replace(M, diags={**M.diags, (0, 0): "poison"})
    vcts = [CTX.encrypt(linalg.encode_vector(CTX, rng.uniform(-1, 1, 8), 4))
            for _ in range(2)]
    rot_ct = _ct()
    out = engine.run([FheRequest(0, "matvec", vcts[0], matrix=poisoned),
                      FheRequest(1, "matvec", vcts[1], matrix=M),
                      FheRequest(2, "rotate", rot_ct, r=1)])
    assert set(out) == {1, 2} and set(engine.stats["failed"]) == {0}
    assert engine.stats["failed"][0].startswith("AttributeError:")
    assert _eq(out[1], linalg.matvec(plan, M, vcts[1])) and _eq(out[2], plan.rotate(rot_ct, 1))
    assert engine.stats["groups"]["matvec@L2"] == 1


def test_identity_rotation_skips_level_check():
    engine = CkksServeEngine(CTX.plan(), batch_tile=2)
    z = RnsPoly(torch.zeros((0, CTX.n), dtype=torch.int32), (), True)
    dead = Ciphertext(z, z, 1.0)
    out = engine.run([FheRequest(0, "rotate", dead, r=0),
                      FheRequest(1, "rotate", dead, r=CTX.slots),
                      FheRequest(2, "rotate", dead, r=-3 * CTX.slots),
                      FheRequest(3, "rotate", dead, r=3)])
    assert set(out) == {0, 1, 2}
    assert engine.stats["identity"] == 3 and engine.stats["dispatches"] == 0
    assert "prime chain exhausted" in engine.stats["failed"][3]
    for rid in (0, 1, 2):
        assert _eq(out[rid], dead) and out[rid] is not dead


def test_request_validation():
    with pytest.raises(ValueError, match="unknown op"):
        FheRequest(0, "bootstrap", _ct())
    with pytest.raises(ValueError, match="needs 'other'"):
        FheRequest(0, "multiply", _ct())
    with pytest.raises(ValueError, match="needs 'matrix'"):
        FheRequest(0, "matvec", _ct())
    engine = CkksServeEngine(CTX.plan(), batch_tile=4)
    ct = _ct()
    with pytest.raises(ValueError, match="duplicate"):
        engine.run([FheRequest(1, "rescale", ct), FheRequest(1, "rescale", ct)])
    with pytest.raises(ValueError, match="batch_tile"):
        CkksServeEngine(CTX.plan(), batch_tile=0)
    assert CkksServeEngine(CTX.plan()).batch_tile == serve.DEFAULT_BATCH_TILE == 8


def _mixed_queue(plan, M):
    vct = CTX.encrypt(linalg.encode_vector(CTX, RNG.uniform(-1, 1, 8), 4))
    dropped = plan.rescale(_ct())
    return [FheRequest(0, "multiply", _ct(), other=_ct()),
            FheRequest(1, "rotate", _ct(), r=-1),
            FheRequest(2, "rotate", _ct(), r=CTX.slots + 3),
            FheRequest(3, "rotate", _ct(), r=2 * CTX.slots),
            FheRequest(4, "conjugate", _ct()),
            FheRequest(5, "rescale", _ct()),
            FheRequest(6, "matvec", vct, matrix=M),
            FheRequest(7, "rescale", dropped),
            FheRequest(8, "rotate", dropped, r=1)]


def test_async_bit_exact_vs_sync_oracle_and_order_invariant():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=4)
    M = _matrix()
    reqs = _mixed_queue(plan, M)
    want = engine.run(list(reqs))
    sync_stats = dict(engine.stats)
    got = engine.run_async(reqs)
    assert engine.stats["mode"] == "async" and set(got) == set(want) == set(range(9))
    assert all(_eq(got[r], want[r]) for r in want)
    for c in ("batched_ops", "identity", "key_switches", "decomposes", "hoisted_reuse"):
        assert engine.stats[c] == sync_stats[c], c
    assert _eq(got[1], plan.rotate(reqs[1].ct, -1))
    assert _eq(got[6], linalg.matvec(plan, M, reqs[6].ct))
    for seed in (1, 2):
        perm = np.random.default_rng(seed).permutation(len(reqs))
        again = engine.run_async([reqs[i] for i in perm])
        assert set(again) == set(want) and all(_eq(again[r], want[r]) for r in want)


def test_rotation_group_element_wrapping():
    plan = CTX.plan()
    slots = CTX.slots
    g = plan.rotation_group_element
    assert g(0) == g(slots) == g(-slots) == g(7 * slots) == 1
    for r in (1, 3, slots - 1):
        assert g(-r) == g(slots - r) and g(r + slots) == g(r) and g(r) != 1
    ct = _ct()
    assert _eq(plan.rotate(ct, -1), plan.rotate(ct, slots - 1))


def test_async_mixed_bases_never_stall_and_max_batch_caps():
    plan = CTX.plan()
    engine = CkksServeEngine(plan, batch_tile=2)
    full = [_ct() for _ in range(3)]
    dropped = [plan.rescale(_ct()) for _ in range(3)]
    reqs = []
    for i, (f, d) in enumerate(zip(full, dropped)):
        reqs += [FheRequest(2 * i, "rotate", f, r=1), FheRequest(2 * i + 1, "rotate", d, r=2)]
    out = engine.run_async(reqs)
    assert engine.stats["groups"] == {"galois@L2": 3, "galois@L1": 3}
    for i, (f, d) in enumerate(zip(full, dropped)):
        assert _eq(out[2 * i], plan.rotate(f, 1)) and _eq(out[2 * i + 1], plan.rotate(d, 2))
    capped = CkksServeEngine(plan, batch_tile=2, max_batch=4)
    reqs = [FheRequest(i, "rotate", _ct(), r=1 + i % 3) for i in range(10)]
    out = capped.run_async(reqs)
    assert set(out) == set(range(10)) and capped.stats["dispatches"] >= 3
    assert all(_eq(out[i], plan.rotate(reqs[i].ct, 1 + i % 3)) for i in range(10))
    with pytest.raises(ValueError, match="max_batch"):
        CkksServeEngine(plan, batch_tile=4, max_batch=2)


def test_synthetic_trace_poisson_latency_stats():
    M = _matrix()
    reqs, arr = synthetic_trace(CTX, 12, seed=4, rate=2000.0, matrix=M)
    reqs2, arr2 = synthetic_trace(CTX, 12, seed=4, rate=2000.0, matrix=M)
    assert arr == arr2 and len(arr) == 12 and [r.op for r in reqs] == [r.op for r in reqs2]
    assert all(a <= b for a, b in zip(arr, arr[1:]))
    engine = CkksServeEngine(CTX.plan(), batch_tile=4)
    out = engine.run_async(reqs, arr)
    stats = engine.stats
    assert set(out) | set(stats["failed"]) == set(range(12))
    lat = stats["latency_us"]
    assert lat["count"] == 12 and 0 < lat["p50"] <= lat["p99"] <= lat["max"]
    assert stats["max_queue"] >= 1 and stats["fresh_traces"] == 0
    want = engine.run(reqs)
    assert set(out) == set(want) and all(_eq(out[r], want[r]) for r in want)
    with pytest.raises(ValueError, match="arrivals"):
        engine.run_async(reqs, arr[:-1])


# ------------------------------------------------ prepare and the graphs

PREPARE = dict(rotations=(1, 2), conjugate=True, hoisted_sets=((1, 3),))


def test_cpu_plan_captures_nothing():
    """A CPU plan runs its programs eagerly: a covering prepare with every
    switch on, and the traffic after it, capture no graph."""
    ctx = _ctx(seed=93)
    plan = ctx.plan()
    before = TEP.EvalPlan.trace_count()
    M = linalg.PtMatrix.encode(ctx, np.eye(4))
    plan.prepare(warm_jit=True, batch_sizes=(2, 4), matvecs=(M,), **PREPARE)
    engine = CkksServeEngine(plan, batch_tile=2)
    reqs, _ = synthetic_trace(ctx, 6, seed=3, matrix=M)
    engine.run(reqs)
    assert plan._graphs is None
    assert TEP.EvalPlan.trace_count() == before and engine.stats["fresh_traces"] == 0


def _every_program(plan, cts, M):
    plan.multiply(cts[0], cts[1])
    plan.rescale(cts[0])
    plan.rotate(cts[0], 1)
    plan.multiply_many(cts, cts)
    plan.rescale_many(cts)
    plan.rotate_many(cts, [1, 1])
    plan.rotate_many(cts, [1, 2])
    plan.rotate_hoisted(cts[0], [1, 2])
    linalg.matvec(plan, M, cts[0])


def test_no_program_builds_a_tensor_from_host_data(monkeypatch):
    """Once a plan's tables, keys, gather rows and matrix packs exist,
    none of the nine programs makes a tensor from host data or moves one
    between devices (a pageable host copy cannot be captured in a CUDA
    graph): every program runs with those calls made to raise."""
    ctx = _ctx(seed=95)
    plan = ctx.plan()
    M = linalg.PtMatrix.encode(ctx, np.random.default_rng(96).uniform(-1, 1, (8, 4)))
    plan.prepare(rotations=(1, 2), matvecs=(M,))
    cts = [ctx.encrypt(ctx.encode(np.full(ctx.slots, 0.25 * (i + 1)))) for i in range(2)]
    _every_program(plan, cts, M)            # fills every lazily cached table
    ran = []
    real = TEP.EvalPlan._program

    def record(self, name, *args, **kw):
        ran.append(name)
        return real(self, name, *args, **kw)

    def refuse(what):
        def call(*args, **kw):
            raise AssertionError(f"{what} inside a scheme program")
        return call

    monkeypatch.setattr(TEP.EvalPlan, "_program", record)
    for mod, name in ((torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
                      (torch.Tensor, "to"), (torch.Tensor, "cpu"), (torch.Tensor, "cuda"),
                      (torch.Tensor, "numpy"), (torch.Tensor, "item"), (torch.Tensor, "tolist")):
        monkeypatch.setattr(mod, name, refuse(f"{getattr(mod, '__name__', mod)}.{name}"))
    with torch.no_grad():
        _every_program(plan, cts, M)
    assert set(ran) == {"multiply", "rescale", "galois_ks", "multiply_many",
                        "rescale_many", "galois_ks_many", "hoisted_galois",
                        "plain_mac", "accumulate"}


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device (as in test_torch_rules)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        plain = lambda a: a.as_subclass(torch.Tensor) if isinstance(a, cls) else a
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*map(plain, args), **{k: plain(v) for k, v in (kwargs or {}).items()})
            return out.as_subclass(cls) if type(out) is torch.Tensor else out

    @property
    def device(self):
        return torch.device("cuda", 0)


class _FailingLauncher:
    """A loaded library whose launchers return a CUDA error (700, an
    illegal address)."""

    def __getattr__(self, fn):
        return lambda *args: 700


@pytest.mark.parametrize("drain", ["run", "run_async"])
def test_launch_failure_in_a_served_matvec_raises(monkeypatch, drain):
    """The hoisted digit gather of a matvec reaches its kernel path (its
    tensors made to report the card) and the launcher fails: the drain
    raises the LaunchError instead of recording a failed request, and no
    other answer is delivered as if the card were sound."""
    ctx = _ctx(seed=97)
    M = linalg.PtMatrix.encode(ctx, np.random.default_rng(98).uniform(-1, 1, (8, 4)))
    vct = ctx.encrypt(linalg.encode_vector(ctx, np.ones(8), 4))
    reqs = [FheRequest(0, "matvec", vct, matrix=M), FheRequest(1, "rotate", vct, r=1)]
    monkeypatch.setattr(build, "load", lambda name: _FailingLauncher())
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    real = galois_kernel.galois_digits
    fake = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta").as_subclass(_FakeCuda)
    monkeypatch.setattr(galois_kernel, "galois_digits",
                        lambda x, idx, *, shared: real(fake(x), fake(idx), shared=shared))
    engine = CkksServeEngine(ctx.plan(), batch_tile=2)
    with pytest.raises(K.LaunchError, match="galois_digits: kernel launch failed"):
        getattr(engine, drain)(reqs)
    assert K.is_device_fault(K.LaunchError("x"))


@pytest.mark.parametrize("fault,is_device", [
    (build.BuildError("nvcc not found"), True),
    (K.LaunchError("galois_digits: kernel launch failed with CUDA error 700"), True),
    (K.KernelRefusal("x must be contiguous"), True),
    (K.GraphError("multiply: CUDA graph capture failed"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (ValueError("multiply: operand bases differ"), False),
    (AttributeError("'str' object has no attribute 'data'"), False),
    (TypeError("unsupported operand"), False),
    (RuntimeError("The size of tensor a (64) must match the size of tensor b (32)"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, Exception) else str(v))
def test_device_faults_are_told_from_request_faults(fault, is_device):
    """What a serve handler re-raises (a fault of the card) and what it
    records against the request: a refusal is still a ValueError for
    callers that catch one, but a device fault."""
    assert K.is_device_fault(fault) == is_device
    assert isinstance(K.KernelRefusal("x"), ValueError)
