"""The port's optimizer (``optim/adamw.py``) against the reference's on
the CPU: ``schedule_fn`` for all four schedules over steps that cross
the warm-up and the decay boundaries, the int8 moment codec
(``_q8_block`` on odd and prime last dims, ``_q8_encode`` /
``_q8_decode``), ``global_norm``, ``init_opt_state`` and
``apply_updates`` from the same params, grads and state (float32 and
int8 moments, with and without clipping).  Bit for bit: the schedules,
the codec, ``init_opt_state`` and an unclipped float32-moment step (the
port writes XLA's rewrites of the reference's float32 code as XLA
compiles them: reciprocal products for constant divisors, a / (b * c)
for (a / b) / c, fused multiply-adds; ``optim/adamw.py``).  Within a few
ulps of each leaf's largest value: ``global_norm`` (XLA sums a leaf's
squares in its own order, 1 ulp seen), a clipped step (the clip scale
carries that ulp into every gradient, 4 seen) and an int8-moment step
(XLA fuses one product or the other by its loop's shape, 1 seen).  Then the
reference's own behavioural cases on the port
(``tests/test_train_substrate.py``): a quadratic converges, and int8
moments track float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref

from repro_torch import tree as T
from repro_torch.optim import adamw

SCHEDULES = ("cosine", "wsd", "linear", "const")


def cfgs(**kw):
    return ref.AdamWConfig(**kw), adamw.AdamWConfig(**kw)


def np_tree(tree):
    """A nest of dicts of tensors or arrays as numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def assert_trees_equal(port, want):
    port, want = np_tree(port), np_tree(want)
    pf, wf = T.flatten_with_path(port), T.flatten_with_path(want)
    assert [p for p, _ in pf] == [p for p, _ in wf]
    for (path, a), (_, b) in zip(pf, wf):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_config_equals_reference():
    import dataclasses
    assert dataclasses.asdict(ref.AdamWConfig()) == dataclasses.asdict(adamw.AdamWConfig())
    assert adamw.BLOCK == ref.BLOCK


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("warmup,total,decay", [(10, 100, 0.1), (20, 40, 0.25),
                                                (0, 7, 0.5), (100, 10_000, 0.1)])
def test_schedule_equals_reference(schedule, warmup, total, decay):
    rc, pc = cfgs(schedule=schedule, warmup_steps=warmup, total_steps=total,
                  decay_frac=decay, lr=3e-4)
    steps = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                    int(total * (1 - decay)) - 1, int(total * (1 - decay)),
                    int(total * (1 - decay)) + 1, total - 1, total, total + 5} - {-1})
    want = np.asarray(jax.jit(jax.vmap(lambda s: ref.schedule_fn(rc, s)))(
        jnp.asarray(steps, jnp.int32)))
    got = np.array([adamw.schedule_fn(pc, torch.tensor(s, dtype=torch.int32)).item()
                    for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 7, 97, 251, 256, 257, 384, 509, 576, 1000, 1536])
def test_q8_block_equals_reference(d):
    assert adamw._q8_block(d) == ref._q8_block(d)


@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (2, 251), (4, 512), (2, 3, 576),
                                   (9, 1031)])
def test_q8_codec_equals_reference(shape):
    x = np.random.default_rng(len(shape) + sum(shape)).standard_normal(shape).astype(np.float32)
    renc = jax.jit(ref._q8_encode)(jnp.asarray(x))
    enc = adamw._q8_encode(torch.from_numpy(x))
    assert_trees_equal(enc, renc)
    np.testing.assert_array_equal(adamw._q8_decode(enc, shape).numpy(),
                                  np.asarray(ref._q8_decode(renc, shape)))


def tree_pair(rng, shapes):
    """The same float32 tree for both packages, a leaf at each shape."""
    t = T.map_tree(lambda s: np.asarray(rng.standard_normal(s), np.float32), shapes)
    return (jax.tree.map(jnp.asarray, t), T.map_tree(torch.from_numpy, t))


SHAPES = {"w": (8, 24), "b": (24,), "blk": {"a": (3, 5, 7), "z": (2, 257)}, "s": ()}


def test_global_norm_near_reference():
    """Within GNORM_ULPS (XLA's summation order); a leaf short enough to
    be summed in one order gives the same bits."""
    rng = np.random.default_rng(1)
    rt, pt = tree_pair(rng, SHAPES)
    assert ulps(adamw.global_norm(pt).numpy(), jax.jit(ref.global_norm)(rt)) <= GNORM_ULPS
    rt, pt = tree_pair(rng, {"a": (4,), "b": (3,)})
    np.testing.assert_array_equal(adamw.global_norm(pt).numpy(),
                                  np.asarray(jax.jit(ref.global_norm)(rt)))


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_init_opt_state_equals_reference(moments):
    rt, pt = tree_pair(np.random.default_rng(2), SHAPES)
    rc, pc = cfgs(moments_dtype=moments)
    assert_trees_equal(adamw.init_opt_state(pt, pc), ref.init_opt_state(rt, rc))


def ulps(a, b) -> float:
    """max |a - b| in units of the last place of max |b| (float32)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a.astype(np.float64) - b))
                 / np.spacing(np.max(np.abs(b))))


def assert_trees_near(port, want, limit):
    """Every float leaf within ``limit`` ulps, int8 codes within 1, ints equal."""
    pf, wf = T.flatten_with_path(np_tree(port)), T.flatten_with_path(np_tree(want))
    assert [p for p, _ in pf] == [p for p, _ in wf]
    for (path, a), (_, b) in zip(pf, wf):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            assert np.max(np.abs(a.astype(int) - b.astype(int)), initial=0) <= 1, path
        elif a.dtype.kind == "f":
            assert ulps(a, b) <= limit, (path, ulps(a, b))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("schedule", ["wsd", "cosine"])
def test_apply_updates_equals_reference(moments, schedule):
    """Three steps from the same params and grads, no clipping.  float32
    moments: params, state and ``lr`` bit for bit after each.  int8
    moments: within INT8_ULPS, the codes within one (XLA picks which
    product of b * m + (1 - b) * g it fuses by the shape of its loop, and
    the port fuses the one it picks at most shapes).  ``grad_norm``
    within GNORM_ULPS: XLA sums each leaf's squares in its own order, and
    unclipped the norm reaches nothing else."""
    rng = np.random.default_rng(3)
    rc, pc = cfgs(lr=1e-2, moments_dtype=moments, clip_norm=1e9, schedule=schedule,
                  warmup_steps=2, total_steps=5)
    rp, pp = tree_pair(rng, SHAPES)
    rs, ps = ref.init_opt_state(rp, rc), adamw.init_opt_state(pp, pc)
    rstep = jax.jit(lambda p, g, s: ref.apply_updates(p, g, s, rc))
    for _ in range(3):
        rg, pg = tree_pair(rng, SHAPES)
        rp, rs, rm = rstep(rp, rg, rs)
        pp, ps, pm = adamw.apply_updates(pp, pg, ps, pc)
        if moments == "float32":
            assert_trees_equal(pp, rp)
            assert_trees_equal(ps, rs)
        else:
            assert_trees_near(pp, rp, INT8_ULPS)
            assert_trees_near(ps, rs, INT8_ULPS)
        np.testing.assert_array_equal(pm["lr"].numpy(), np.asarray(rm["lr"]))
        assert ulps(pm["grad_norm"], rm["grad_norm"]) <= GNORM_ULPS


GNORM_ULPS = 1          # global_norm against XLA's summation order (1 seen)
INT8_ULPS = 2           # an int8-moment step (1 seen)
CLIP_ULPS = 8           # a clipped step: every gradient scaled by clip / norm (4 seen)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_apply_updates_clipped_near_reference(moments):
    """Clipped steps: the clip scale carries ``grad_norm``'s ulp into
    every gradient, so params and moments agree within CLIP_ULPS of each
    leaf's largest value (the step and lr exactly; int8 codes within one)."""
    rng = np.random.default_rng(5)
    rc, pc = cfgs(lr=1e-2, moments_dtype=moments, clip_norm=0.5, warmup_steps=2,
                  total_steps=5)
    rp, pp = tree_pair(rng, SHAPES)
    rs, ps = ref.init_opt_state(rp, rc), adamw.init_opt_state(pp, pc)
    rstep = jax.jit(lambda p, g, s: ref.apply_updates(p, g, s, rc))
    for _ in range(3):
        rg, pg = tree_pair(rng, SHAPES)
        rp, rs, rm = rstep(rp, rg, rs)
        pp, ps, pm = adamw.apply_updates(pp, pg, ps, pc)
        assert float(pm["grad_norm"]) > 0.5
        assert_trees_near(pp, rp, CLIP_ULPS)
        assert_trees_near(ps, rs, CLIP_ULPS)
        np.testing.assert_array_equal(pm["lr"].numpy(), np.asarray(rm["lr"]))


def test_apply_updates_leaves_its_inputs():
    rng = np.random.default_rng(4)
    _, p = tree_pair(rng, SHAPES)
    _, g = tree_pair(rng, SHAPES)
    c = adamw.AdamWConfig()
    s = adamw.init_opt_state(p, c)
    before = [x.clone() for x in T.leaves(p) + T.leaves(s)]
    adamw.apply_updates(p, g, s, c)
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(p) + T.leaves(s)))


def test_adamw_converges_quadratic():
    c = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, schedule="const", warmup_steps=0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_opt_state(params, c)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw w^2
        params, state, _ = adamw.apply_updates(params, grads, state, c)
    assert float(torch.max(torch.abs(params["w"]))) < 0.1


def test_adamw_int8_moments_track_fp32():
    kw = dict(lr=0.01, weight_decay=0.0, schedule="const", warmup_steps=0)
    cf = adamw.AdamWConfig(**kw)
    ci = adamw.AdamWConfig(**kw, moments_dtype="int8")
    rng = np.random.default_rng(0)
    p0 = {"w": torch.from_numpy(rng.normal(0, 1, (512,)).astype(np.float32))}
    pf, pi = p0, p0
    sf, si = adamw.init_opt_state(p0, cf), adamw.init_opt_state(p0, ci)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(0, 1, (512,)).astype(np.float32))}
        pf, sf, _ = adamw.apply_updates(pf, g, sf, cf)
        pi, si, _ = adamw.apply_updates(pi, g, si, ci)
    df, di = pf["w"] - p0["w"], pi["w"] - p0["w"]
    cos = float(torch.dot(df, di) / (torch.linalg.norm(df) * torch.linalg.norm(di)))
    assert cos > 0.99, f"int8-Adam trajectory decorrelated: cos={cos}"
    assert float(torch.max(torch.abs(pf["w"] - pi["w"]))) < 0.1


def test_schedules_shape():
    for sched in SCHEDULES:
        c = adamw.AdamWConfig(schedule=sched, warmup_steps=10, total_steps=100)
        lr = lambda s: float(adamw.schedule_fn(c, torch.tensor(s)))
        assert lr(0) < lr(50)
        if sched != "const":
            assert lr(100) <= lr(50) + 1e-9
    c = adamw.AdamWConfig(schedule="wsd", warmup_steps=10, total_steps=100, decay_frac=0.2)
    assert float(adamw.schedule_fn(c, torch.tensor(30))) == \
        float(adamw.schedule_fn(c, torch.tensor(60)))
