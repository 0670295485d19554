"""The port's prime-sharded EvalPlan (``EvalPlan(ctx, mesh=...)`` with a
"k" axis) against the reference's unsharded plan on the CPU: over "k"
meshes of 2 and 4 CPU shards and a ("b", "k") 2 x 2 mesh, every program
at a basis of 4 primes (split over "k") and after one rescale at 3 (a
basis the axis does not divide, so the programs run unsharded) gives the
reference's integers, and the plans count the same ``stats``.  Also the
key switch's two phases around the exchange against ``decompose_banks``,
the shard bases' tables on both layouts, the graph and table keys of two
shards on one device, the ``plan.program`` spans, a failure inside a
shard, and a natural-order ring (n = 2^13) against the port's unsharded
plan."""
import numpy as np
import pytest
import torch

from repro.fhe import linalg as RL
from repro.fhe import rns as ref_rns
from repro.fhe.ckks import CkksContext as RefContext

from repro_torch import obs
from repro_torch.convert import tensor_to_u32
from repro_torch.fhe import batched as FB
from repro_torch.fhe import evalplan as EP
from repro_torch.fhe import linalg, rns
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import EvalPlan
from repro_torch.mesh import make_mesh

torch.set_num_threads(2)

N, LEVELS, SEED = 64, 3, 13
PREPARE = dict(rotations=(1, 2, 3, -1), conjugate=True)
MESHES = {
    "k2": (["cpu"] * 2, ("k",), None),
    "k4": (["cpu"] * 4, ("k",), None),
    "b2k2": (["cpu"] * 4, ("b", "k"), (2, 2)),
}
LEVEL_IDS = ["4 primes", "3 primes"]


def _mesh(name):
    devices, axes, shape = MESHES[name]
    return make_mesh(devices, axes, shape)


def _ref_eq(r, p) -> bool:
    return (r.primes == p.primes and r.scale == p.scale
            and np.array_equal(np.asarray(r.c0.data), tensor_to_u32(p.c0.data))
            and np.array_equal(np.asarray(r.c1.data), tensor_to_u32(p.c1.data)))


def _all_eq(rs, ps) -> bool:
    return len(rs) == len(ps) and all(_ref_eq(r, p) for r, p in zip(rs, ps))


@pytest.fixture(scope="module")
def pair():
    """A reference and a port context with one seed, both prepared alike at
    the full basis and one level down (every key drawn in one order), 5
    ciphertexts encrypted alike, and an 8 x 8 matrix packed at each basis.
    Returns (ref, port, {level: (ref cts, port cts, ref pack, port pack)})."""
    ref = RefContext(n=N, levels=LEVELS, seed=SEED)
    port = CkksContext(n=N, levels=LEVELS, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    W = rng.uniform(-1, 1, (8, 8))
    packs = {}
    for level, basis in zip(LEVEL_IDS, (tuple(port.qs), tuple(port.qs[:-1]))):
        packs[level] = (RL.PtMatrix.encode(ref, W, basis=basis),
                        linalg.PtMatrix.encode(port, W, basis=basis))
        ref.plan().prepare(basis=basis, warm_jit=False, matvecs=packs[level][:1], **PREPARE)
        port.plan().prepare(basis=basis, matvecs=packs[level][1:], **PREPARE)
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2) for _ in range(5)]
    rc = [ref.encrypt(ref.encode(z)) for z in zs]
    pc = [port.encrypt(port.encode(z)) for z in zs]
    levels = {"4 primes": (rc, pc, *packs["4 primes"]),
              "3 primes": (ref.plan().rescale_many(rc), port.plan().rescale_many(pc),
                           *packs["3 primes"])}
    return ref, port, levels


OPS = {
    # name -> (ciphertexts, plan, matrix pack, linalg module) -> answers
    "multiply": lambda cts, plan, M, L: [plan.multiply(cts[0], cts[1])],
    "rescale": lambda cts, plan, M, L: [plan.rescale(cts[2])],
    "rotate": lambda cts, plan, M, L: [plan.rotate(cts[0], 1)],
    "conjugate": lambda cts, plan, M, L: [plan.conjugate(cts[1])],
    "multiply_many": lambda cts, plan, M, L: plan.multiply_many(cts[:3], cts[1:4]),
    "rescale_many": lambda cts, plan, M, L: plan.rescale_many(cts[:3]),
    "rotate_many mixed": lambda cts, plan, M, L: plan.rotate_many(cts[:3], [1, 2, -1]),
    "rotate_many uniform": lambda cts, plan, M, L: plan.rotate_many(cts[:3], [2, 2, 2]),
    "conjugate_many": lambda cts, plan, M, L: plan.conjugate_many(cts[:3]),
    "rotate_hoisted": lambda cts, plan, M, L: plan.rotate_hoisted(cts[0], [1, 2, 3]),
    "rotate_sum": lambda cts, plan, M, L: [L.rotate_sum(plan, cts[3], 4)],
    "matvec": lambda cts, plan, M, L: [L.matvec(plan, M, cts[4])],
}


@pytest.fixture(scope="module")
def ref_answers(pair):
    ref, _, levels = pair
    plan = ref.plan()
    return {(level, op): f(rc, plan, RM, RL)
            for level, (rc, _, RM, _) in levels.items() for op, f in OPS.items()}


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("level", LEVEL_IDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_kshard_plan_equals_reference_unsharded(pair, ref_answers, mesh, level, op):
    _, port, levels = pair
    _, pc, _, PM = levels[level]
    plan = EvalPlan(port, mesh=_mesh(mesh))
    assert _all_eq(ref_answers[(level, op)], OPS[op](pc, plan, PM, linalg))
    # 4 primes split over "k" of 2 and 4; 3 primes divide neither
    if level == "3 primes":
        assert plan.k_programs == 0
    elif mesh == "b2k2" and op not in ("multiply", "rescale", "rotate", "conjugate",
                                       "rotate_sum"):
        assert plan.k_programs == 0          # the batched programs go over "b"
    else:
        assert plan.k_programs > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kshard_stats_equal_the_reference(pair, mesh):
    """Every program at both levels counts, on the sharded plan, what the
    reference's unsharded plan counts; ``mesh_devices`` is the "b" axis."""
    ref, port, levels = pair
    rplan = ref.plan().reset_stats()
    plan = EvalPlan(port, mesh=_mesh(mesh))
    for rc, pc, RM, PM in levels.values():
        for f in OPS.values():
            f(rc, rplan, RM, RL)
            f(pc, plan, PM, linalg)
    assert plan.stats == rplan.stats
    assert plan.mesh_devices == (2 if mesh == "b2k2" else 1)


def test_program_spans_name_the_k_shards(pair):
    """Over "k" of 2 a multiply runs each shard's front, then each back,
    one ``plan.program`` span each with its ``kshard``; at 3 primes the
    one unsharded program has none."""
    _, port, levels = pair
    plan = EvalPlan(port, mesh=_mesh("k2"))
    obs.enable()
    obs.clear()
    try:
        for level in LEVEL_IDS:
            cts = levels[level][1]
            plan.multiply(cts[0], cts[1])
        spans = [e["args"] for e in obs.events() if e["name"] == "plan.program"]
    finally:
        obs.disable()
        obs.clear()
    assert [(s["program"], s.get("kshard")) for s in spans] == [
        ("multiply_many/front", 0), ("multiply_many/front", 1), ("multiply_many/back", 0),
        ("multiply_many/back", 1), ("multiply_many", None)]
    assert plan.k_programs == 1


def test_two_shards_on_one_device_get_their_own_graphs_and_tables(pair):
    """Shards on one device have equal shapes and different primes: each
    program's graph key (the signature ``_call`` builds a CUDA graph
    under) and its tables name the shard's block, so shard 1 never
    replays shard 0's graph or reads its tables."""
    _, port, levels = pair
    plan = EvalPlan(port, mesh=_mesh("k2"))
    calls = []
    real = plan._call

    def record(name, fn, inputs, consts, key):
        calls.append((name, key, tuple(x.shape for x in inputs), consts))
        return real(name, fn, inputs, consts, key)
    plan._call = record
    cts = levels["4 primes"][1]
    plan.multiply(cts[0], cts[1])
    plan.rescale(cts[0])
    basis = cts[0].primes
    P = port.special
    for name, blocks in (("multiply_many/front", [basis[:2] + (P,), basis[2:] + (P,)]),
                         ("multiply_many/back", [basis[:2] + (P,), basis[2:] + (P,)]),
                         ("rescale_many", [basis[:2] + basis[3:], basis[2:]])):
        shard = [c for c in calls if c[0] == name]
        assert [key for _, key, _, _ in shard] == [(basis, b) for b in blocks], name
        t = [consts[-2] for *_, consts in shard]
        assert [tuple(tensor_to_u32(x["qs"]).tolist()) for x in t] == blocks, name
    fronts = [c for c in calls if c[0] == "multiply_many/front"]
    assert fronts[0][2] == fronts[1][2]                  # equal shapes, other keys


@pytest.mark.parametrize("n", [64, 8192], ids=["bitrev 64", "four-step 8192"])
@pytest.mark.parametrize("shard", [0, 1])
def test_shard_basis_tables_are_the_full_packs_rows(n, shard):
    """A shard basis (its block of 2 of 4 primes, then P) has the tables
    of those primes' rows of the reference's full key-switch pack, and
    pinv = P^-1 mod each of its primes."""
    primes = rns.make_primes(n, 5)
    basis, P = tuple(primes[1:]), primes[0]
    full = basis + (P,)
    sb = basis[2 * shard:2 * shard + 2] + (P,)
    rows = [full.index(q) for q in sb]
    plan = EvalPlan(CkksContext(n=n, levels=3, seed=1, device="cpu"))
    t, fsp = plan._packs(sb, torch.device("cpu"))
    want_pinv = [pow(P, -1, q) for q in sb[:-1]]
    assert tensor_to_u32(t["pinv"]).tolist() == want_pinv
    if fsp is None:
        ref_t = ref_rns.basis_pack(full, n)
        for key in FB._PACK_KEYS:
            assert np.array_equal(tensor_to_u32(t[key]), np.asarray(ref_t[key])[rows]), key
    else:
        ref_f = ref_rns.fourstep_basis_pack(full, n)
        assert np.array_equal(tensor_to_u32(t["qs"]), np.asarray(ref_f["qs"])[rows])
        for key, v in fsp.items():
            if isinstance(v, dict):
                for sub in FB._PACK_KEYS:
                    assert np.array_equal(tensor_to_u32(v[sub]),
                                          np.asarray(ref_f[key][sub])[rows]), (key, sub)
            else:
                assert np.array_equal(tensor_to_u32(v), np.asarray(ref_f[key])[rows]), key


@pytest.mark.parametrize("n", [64, 8192], ids=["bitrev 64", "four-step 8192"])
@pytest.mark.parametrize("s", [2, 4])
def test_phases_around_the_exchange_equal_decompose_banks(n, s):
    """Each of s shards runs phase (A) on its block of d2 under its shard
    basis' tables, the blocks are gathered, and (B) extends all 4 digits
    onto its shard basis: the full decomposition's rows of those primes."""
    plan = EvalPlan(CkksContext(n=n, levels=3, seed=1, device="cpu"))
    basis = tuple(plan.ctx.qs)
    full = basis + (plan.ctx.special,)
    t, fsp = plan._packs(full, torch.device("cpu"))
    rng = np.random.default_rng(n + s)
    d2 = torch.from_numpy(np.stack([rng.integers(0, q, (2, n)) for q in basis])
                          .astype(np.int32))
    want = FB.decompose_banks(d2, t, fsp=fsp)                # (4, 5, 2, n)
    m = len(basis) // s
    shards = [(slice(j * m, (j + 1) * m), *plan._packs(basis[j * m:(j + 1) * m] + full[-1:],
                                                        torch.device("cpu")))
              for j in range(s)]
    digits = torch.cat([FB.decompose_intt(d2[rows], ts, fsp=fs) for rows, ts, fs in shards])
    assert torch.equal(digits, FB.decompose_intt(d2, t, fsp=fsp))
    for rows, ts, fs in shards:
        got = FB.decompose_extend(digits, t["qs"], ts, fsp=fs)
        keep = list(range(rows.start, rows.stop)) + [len(basis)]
        assert torch.equal(got, want[:, keep]), rows


def test_a_failing_shard_raises(pair, monkeypatch):
    """A failure inside a shard's program raises out of the scheme op; the
    plan never falls back to running the op unsharded."""
    _, port, levels = pair
    plan = EvalPlan(port, mesh=_mesh("k2"))
    cts = levels["4 primes"][1]

    def broken(*args):
        raise RuntimeError("shard program failed")
    monkeypatch.setattr(EP, "multiply_many_back", broken)
    with pytest.raises(RuntimeError, match="shard program failed"):
        plan.multiply(cts[0], cts[1])
    assert plan.stats["dispatches"] == 0


def test_natural_order_ring_over_two_shards():
    """n = 2^13 (the four-step layout, natural order), 4 primes over "k"
    of 2: multiply and rotate equal the port's unsharded plan."""
    ctx = CkksContext(n=1 << 13, levels=3, seed=5, device="cpu")
    ctx.plan().prepare(rotations=(1,))
    rng = np.random.default_rng(5)
    a, b = (ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.slots))) for _ in range(2))
    plan = EvalPlan(ctx, mesh=make_mesh(["cpu"] * 2, ("k",)))
    for want, got in ((ctx.plan().multiply(a, b), plan.multiply(a, b)),
                      (ctx.plan().rotate(a, 1), plan.rotate(a, 1))):
        assert torch.equal(want.c0.data, got.c0.data)
        assert torch.equal(want.c1.data, got.c1.data)
    assert plan.k_programs == 2
