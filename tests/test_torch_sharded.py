"""The port's batch-sharded EvalPlan (``EvalPlan(ctx, mesh=...)``, axis
"b") against the reference's unsharded plan on the CPU: over a mesh of
one CPU device and a mesh of 4 CPU shards, every batched op, the hoisted
set and the matvec give the reference's integers (batches padded to the
shard count and the pad rows dropped), and the plans count the same
``stats``; mesh validation, a "k" axis, the per-shard programs, the
serving engine's device-aware sizing against the reference's 1-device
engine, and ``fourstep_ntt_sharded`` against the reference's
``fourstep_ntt``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fourstep as ref_fs
from repro.fhe import linalg as RL
from repro.fhe import serve as RS
from repro.fhe.ckks import CkksContext as RefContext

from repro_torch import obs
from repro_torch.convert import tensor_to_u32
from repro_torch.core import fourstep as fs
from repro_torch.fhe import linalg
from repro_torch.fhe import serve
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import EvalPlan
from repro_torch.mesh import make_mesh

torch.set_num_threads(2)

N, LEVELS, SEED = 64, 2, 7
PREPARE = dict(rotations=(1, 2, 3, -1), conjugate=True)
SHARDS = [1, 4]


def _ref_eq(r, p) -> bool:
    return (r.primes == p.primes and r.scale == p.scale
            and np.array_equal(np.asarray(r.c0.data), tensor_to_u32(p.c0.data))
            and np.array_equal(np.asarray(r.c1.data), tensor_to_u32(p.c1.data)))


def _all_eq(rs, ps) -> bool:
    return len(rs) == len(ps) and all(_ref_eq(r, p) for r, p in zip(rs, ps))


@pytest.fixture(scope="module")
def pair():
    """A reference and a port context with one seed and one prepare, 6
    ciphertexts encrypted alike in each, and an 8 x 8 matrix pack each."""
    ref = RefContext(n=N, levels=LEVELS, seed=SEED)
    port = CkksContext(n=N, levels=LEVELS, seed=SEED, device="cpu")
    ref.plan().prepare(warm_jit=False, **PREPARE)
    port.plan().prepare(**PREPARE)
    rng = np.random.default_rng(SEED)
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2) for _ in range(6)]
    rc = [ref.encrypt(ref.encode(z)) for z in zs]
    pc = [port.encrypt(port.encode(z)) for z in zs]
    W = rng.uniform(-1, 1, (8, 8))
    return ref, port, rc, pc, RL.PtMatrix.encode(ref, W), linalg.PtMatrix.encode(port, W)


def _sharded(port, shards):
    return EvalPlan(port, mesh=make_mesh(["cpu"] * shards))


OPS = {
    # name -> (ciphertexts, plan) -> answers; 6 ciphertexts pad to 8 over
    # 4 shards, the 3 hoisted rotations to 4
    "multiply_many": lambda cts, plan: plan.multiply_many(cts, cts[1:] + cts[:1]),
    "rescale_many": lambda cts, plan: plan.rescale_many(cts[:6]),
    "rotate_many mixed": lambda cts, plan: plan.rotate_many(cts[:6], [1, 2, 0, -1, 2, 3]),
    "rotate_many uniform": lambda cts, plan: plan.rotate_many(cts[:6], [2] * 6),
    "conjugate_many": lambda cts, plan: plan.conjugate_many(cts[:6]),
    "rotate_hoisted": lambda cts, plan: plan.rotate_hoisted(cts[0], [1, 2, 3]),
}


@pytest.fixture(scope="module")
def ref_answers(pair):
    ref, _, rc, _, RM, _ = pair
    plan = ref.plan()
    out = {op: f(rc, plan) for op, f in OPS.items()}
    out["matvec"] = [RL.matvec(plan, RM, rc[0])]
    return out


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("op", list(OPS) + ["matvec"])
def test_sharded_plan_equals_reference_unsharded(pair, ref_answers, shards, op):
    _, port, _, pc, _, PM = pair
    plan = _sharded(port, shards)
    got = [linalg.matvec(plan, PM, pc[0])] if op == "matvec" else OPS[op](pc, plan)
    assert _all_eq(ref_answers[op], got)


@pytest.mark.parametrize("shards", SHARDS)
def test_stats_charge_the_logical_batch(pair, shards):
    """The same traffic on the reference's unsharded plan and the port's
    sharded one counts the same dispatches, key switches and decomposes:
    pad rows are not charged."""
    ref, port, rc, pc, RM, PM = pair
    rplan = ref.plan().reset_stats()
    plan = _sharded(port, shards)
    for cts, p, mv, M in ((rc, rplan, RL.matvec, RM), (pc, plan, linalg.matvec, PM)):
        for f in OPS.values():
            f(cts, p)
        mv(p, M, cts[0])
    assert plan.stats == rplan.stats


def test_each_shard_runs_its_own_program(pair):
    """6 ciphertexts over 4 shards: the batch pads to 8 and each shard runs
    one program of 2 rows (one ``plan.program`` span each, naming its
    shard); a CPU plan captures no graph."""
    _, port, _, pc, _, _ = pair
    plan = _sharded(port, 4)
    seen = []
    real = plan._call

    def record(name, fn, inputs, consts, key):
        seen.append((name, tuple(inputs[0].shape)))
        return real(name, fn, inputs, consts, key)
    plan._call = record
    before = EvalPlan.trace_count()
    obs.enable()
    obs.clear()
    try:
        plan.rescale_many(pc[:6])
        spans = [e for e in obs.events() if e["name"] == "plan.program"]
    finally:
        obs.disable()
        obs.clear()
    assert seen == [("rescale_many", (2, LEVELS + 1, N))] * 4
    assert sorted(s["args"]["shard"] for s in spans) == [0, 1, 2, 3]
    assert all(s["args"]["n"] == 6 for s in spans)
    assert EvalPlan.trace_count() == before and plan._graphs is None


def test_mesh_axis_names_validated(pair):
    _, port, *_ = pair
    with pytest.raises(ValueError, match="mesh axis"):
        EvalPlan(port, mesh=make_mesh(["cpu"], ("batch",)))
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(["cpu"] * 3, ("b", "k"), shape=(2, 2))
    with pytest.raises(ValueError, match="need a shape"):
        make_mesh(["cpu"] * 2, ("b", "k"))


def test_mesh_of_one_is_sharded_and_counts_as_one_device(pair):
    _, port, *_ = pair
    plan = _sharded(port, 1)
    assert plan._shards == (port.device,) and plan.mesh_devices == 1
    assert EvalPlan(port).mesh_devices == 1


def test_k_axis(pair):
    """A "k" axis of size 1 changes nothing (alone: unsharded; beside "b":
    the "b" shards); a larger one equals the unsharded plan too: at 3
    primes, which 2 does not divide, unsharded, and a rescale at 2 primes
    split over "k" (tests/test_torch_kshard.py holds every program)."""
    _, port, _, pc, *_ = pair
    konly = EvalPlan(port, mesh=make_mesh(["cpu"], ("k",)))
    assert konly._shards is None and konly.mesh_devices == 1
    bk = EvalPlan(port, mesh=make_mesh(["cpu"] * 2, ("b", "k"), shape=(2, 1)))
    assert bk.mesh_devices == 2
    k2 = EvalPlan(port, mesh=make_mesh(["cpu"] * 2, ("k",)))
    bk22 = EvalPlan(port, mesh=make_mesh(["cpu"] * 4, ("b", "k"), shape=(2, 2)))
    assert (k2.mesh_devices, bk22.mesh_devices) == (1, 2)
    want = port.plan().multiply_many(pc[:3], pc[3:])
    low = port.plan().rescale(pc[0])
    for plan in (konly, bk, k2, bk22):
        got = plan.multiply_many(pc[:3], pc[3:])
        assert all(torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)
                   for a, b in zip(want, got))
        a, b = port.plan().rescale(low), plan.rescale(low)
        assert torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)
        assert plan.k_programs == (plan in (k2, bk22))


def test_axis_devices_of_a_two_axis_mesh():
    m = make_mesh(["cpu"] * 6, ("b", "k"), shape=(3, 2))
    assert m.shape == {"b": 3, "k": 2}
    assert len(m.axis_devices("b")) == 3 and len(m.axis_devices("k")) == 2
    assert hash(m) == hash(make_mesh(["cpu"] * 6, ("b", "k"), shape=(3, 2)))


TIMING = ("latency_us", "wall_s", "fresh_traces")


def _queue(Request, ctx, cts):
    """9 requests over the 6 ciphertexts and one a level down: multiplies,
    mixed and identity rotations, a conjugation and rescales at two
    levels, so the engine forms groups at two bases."""
    low = ctx.plan().rescale(cts[5])
    return [Request(0, "multiply", cts[0], other=cts[1]),
            Request(1, "rotate", cts[1], r=1), Request(2, "rotate", cts[2], r=-1),
            Request(3, "rotate", cts[3], r=0), Request(4, "conjugate", cts[4]),
            Request(5, "rescale", cts[5]), Request(6, "multiply", cts[2], other=cts[3]),
            Request(7, "rescale", cts[0]), Request(8, "rotate", low, r=2),
            Request(9, "rescale", low)]


@pytest.fixture(scope="module")
def traces(pair):
    """The queue in each package, and the reference's 1-device engine at
    batch_tile = 8 on its own: (answers, stats) of ``run`` and of
    ``run_async``."""
    ref, port, rc, pc = pair[:4]
    rreqs, reqs = _queue(RS.FheRequest, ref, rc), _queue(serve.FheRequest, port, pc)
    engine = RS.CkksServeEngine(ref.plan(), batch_tile=8, max_batch=16)
    return reqs, [(drain(rreqs), dict(engine.stats)) for drain in (engine.run, engine.run_async)]


@pytest.mark.parametrize("shards", SHARDS)
def test_serve_engine_sizes_groups_per_device(pair, traces, shards):
    """The port's engine over a sharded plan at batch_tile = 8 / shards
    groups as the reference's 1-device engine at batch_tile = 8: the same
    answers and ``stats`` but for the devices, whose ``per_device_rows``
    split the reference's one count evenly."""
    port = pair[1]
    reqs, ref_drains = traces
    eng = serve.CkksServeEngine(_sharded(port, shards), batch_tile=8 // shards, max_batch=16)
    assert (eng.devices, eng.group_tile, eng.max_batch) == (shards, 8, 16)
    for drain, (want, rst) in zip((eng.run, eng.run_async), ref_drains):
        got, st = drain(reqs), eng.stats
        assert set(got) == set(want)
        assert all(_ref_eq(want[rid], got[rid]) for rid in want)
        assert set(st) == set(rst)
        for key in set(st) - set(TIMING) - {"devices", "per_device_rows"}:
            assert st[key] == rst[key], key
        assert st["devices"] == shards and rst["devices"] == 1
        assert st["per_device_rows"] == [rst["per_device_rows"][0] // shards] * shards


@functools.lru_cache(maxsize=None)
def _ref_fourstep(n1, neg):
    fsp = ref_fs.make_fourstep_params(n1, n1)
    a = np.random.default_rng(n1).integers(0, fsp.q, size=n1 * n1, dtype=np.uint32)
    return a, np.asarray(ref_fs.fourstep_ntt(jnp.asarray(a), fsp, negacyclic=neg))


@pytest.mark.parametrize("n1", [16, 128])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("neg", [False, True], ids=["cyclic", "negacyclic"])
def test_fourstep_sharded_equals_reference(n1, shards, neg):
    """Columns over 1, 2 and 4 shards, the reorder as copies between them:
    the D matrix read out as A_hat[k2*n1 + k1] = D[k1, k2] is the
    reference's four-step NTT word for word."""
    a, want = _ref_fourstep(n1, neg)
    fsp = fs.make_fourstep_params(n1, n1)
    a2d = torch.from_numpy(a.astype(np.int64).astype(np.int32)).view(n1, n1)
    D = fs.fourstep_ntt_sharded(a2d, fsp, make_mesh(["cpu"] * shards, ("model",)),
                                negacyclic=neg)
    assert D.shape == (n1, n1)
    assert np.array_equal(tensor_to_u32(D.t().contiguous()).reshape(-1), want)


def test_fourstep_sharded_refuses_an_uneven_split():
    fsp = fs.make_fourstep_params(16, 16)
    with pytest.raises(ValueError, match="shards"):
        fs.fourstep_ntt_sharded(torch.zeros((16, 16), dtype=torch.int32), fsp,
                                make_mesh(["cpu"] * 3, ("model",)))
