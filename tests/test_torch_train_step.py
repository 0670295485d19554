"""The port's train step (``train/step.py``) against the reference's on the
CPU: ``_compress_grads`` (``bf16``, ``int8_ef`` with its carried error),
``init_train_state``'s trees, and one full ``make_train_step`` step per
family at ``microbatches`` 1 and 2.

The step starts where the reference's first step left off: the
reference trains one step from its own init, and its params and train
state are carried across (``convert.params_from_reference``,
``convert.train_state_from_reference``), so the moments are not zero
and Adam's update is a smooth function of the gradient (from zero
moments it is sign(g), which float32 rounding can flip where |g| is
tiny).  Then both take the same next step on the same batch.
Tolerance, per leaf of the params, ``m`` and ``v``: max |port - ref| <=
STEP_TOL x max |ref| (1e-4, the gradients' tolerance); the loss and
``grad_norm`` within 1e-4 relative; ``lr`` and ``step`` exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step

from repro_torch import tree as T
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.optim import adamw
from repro_torch.train import step as port_step

from test_torch_train_grads import FAMILY_ARCHS, batch_pair, reference_pair

torch.set_num_threads(2)

STEP_TOL = 1e-4


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def assert_near(port, want, tol, what=""):
    pf, wf = T.flatten_with_path(np_tree(port)), T.flatten_with_path(np_tree(want))
    assert [p for p, _ in pf] == [p for p, _ in wf], what
    for (path, a), (_, b) in zip(pf, wf):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path)
        if a.dtype.kind != "f" or tol == 0:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
        else:
            scale = float(np.max(np.abs(b), initial=0.0))
            err = float(np.max(np.abs(a.astype(np.float64) - b), initial=0.0))
            assert err <= tol * scale, (what, path, err, scale)


def configs(mb, moments="float32", compression="none"):
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8, schedule="wsd", moments_dtype=moments)
    kw = dict(microbatches=mb, remat_policy="full", grad_compression=compression)
    return (ref_step.TrainConfig(opt=ref_adamw.AdamWConfig(**opt), **kw),
            port_step.TrainConfig(opt=adamw.AdamWConfig(**opt), **kw))


@pytest.mark.parametrize("mode", ["bf16", "int8_ef"])
def test_compress_grads_equal_reference(mode):
    """Two rounds, the second carrying the first's error: bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 33), "b": {"c": (7,), "d": (2, 3, 4)}}
    mk = lambda: T.map_tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    g0 = mk()
    rerr = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g0)
    perr = T.map_tree(lambda x: torch.zeros(x.shape), g0)
    rfn = jax.jit(lambda g, e: ref_step._compress_grads(g, e, mode))
    for _ in range(2):
        g = mk()
        rq, rerr = rfn(jax.tree.map(jnp.asarray, g), rerr)
        pq, perr = port_step._compress_grads(T.map_tree(torch.from_numpy, g), perr, mode)
        assert_near(pq, rq, 0)
        assert_near(perr, rerr, 0)
    g = T.map_tree(torch.from_numpy, mk())
    assert port_step._compress_grads(g, None, "none") == (g, None)


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_init_train_state_equals_reference(moments, compression):
    rmodel, params, model = reference_pair("smollm-135m")
    rc, pc = configs(1, moments, compression)
    want = ref_step.init_train_state(rmodel, params, rc)
    got = port_step.init_train_state(model, model.tree(), pc)
    assert_near(got, want, 0)


def reference_after_one_step(arch, rc, rb):
    """The reference's model, and its params and train state after one
    step from its own init."""
    rmodel, params, _ = reference_pair(arch)
    rfn = jax.jit(ref_step.make_train_step(rmodel, rc))
    params, state, _ = rfn(params, ref_step.init_train_state(rmodel, params, rc), rb)
    return rmodel, rfn, params, state


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_equals_reference(family, mb):
    arch = FAMILY_ARCHS[family]
    rc, pc = configs(mb)
    _, _, model = reference_pair(arch)
    rng = np.random.default_rng(20 + mb)
    rb0, _ = batch_pair(model.cfg, rng, b=4)
    rb, tb = batch_pair(model.cfg, rng, b=4)
    _, rfn, params, state = reference_after_one_step(arch, rc, rb0)

    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), "cpu"))
    pstate = train_state_from_reference(jax.tree.map(np.asarray, state), "cpu")
    new_params, new_state, rm = rfn(params, state, rb)
    pstate, pm = port_step.make_train_step(model, pc)(pstate, tb)

    assert model.remat_policy == "full"
    assert set(pm) == {"loss", "grad_norm", "lr"}
    for k in ("loss", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= STEP_TOL * abs(float(rm[k])), k
    assert float(pm["lr"]) == float(rm["lr"])
    assert_near(model.tree(), new_params, STEP_TOL, "params")
    assert_near(pstate, new_state, STEP_TOL, "state")


def test_train_step_int8_moments_and_compression_near_reference():
    """int8 moments and int8_ef compression (its error carried in the
    state): params within STEP_TOL, the error within STEP_TOL of the
    quantized gradient's scale, the decoded moments within a code."""
    rc, pc = configs(1, "int8", "int8_ef")
    _, _, model = reference_pair("smollm-135m")
    rng = np.random.default_rng(30)
    rb0, _ = batch_pair(model.cfg, rng)
    rb, tb = batch_pair(model.cfg, rng)
    _, rfn, params, state = reference_after_one_step("smollm-135m", rc, rb0)
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), "cpu"))
    pstate = train_state_from_reference(jax.tree.map(np.asarray, state), "cpu")
    assert pstate["opt"]["m"]["embed"]["q"].dtype == torch.int8
    new_params, new_state, _ = rfn(params, state, rb)
    pstate, _ = port_step.make_train_step(model, pc)(pstate, tb)
    assert_near(model.tree(), new_params, STEP_TOL, "params")
    # the error is a quantization residual, at most half a code step: the
    # gradients' rounding shows in it at the scale of the quantized values
    # (127 code steps), not at its own
    assert_near(pstate["err"], new_state["err"], 127 * STEP_TOL, "err")
    assert int(pstate["opt"]["step"]) == int(new_state["opt"]["step"]) == 2
    for name in ("m", "v"):
        dec = lambda tree, decode: T.map_tree(lambda e: decode(e, e["q"].shape), tree,
                                              is_leaf=lambda x: isinstance(x, dict) and "q" in x)
        got = dec(pstate["opt"][name], adamw._q8_decode)
        want = dec(jax.tree.map(np.asarray, new_state["opt"][name]),
                   lambda e, s: np.asarray(ref_adamw._q8_decode(e, s)))
        assert_near(got, want, 2 / 127, name)   # a code may move by one


def test_microbatches_match_one_batch():
    """The port's own check, as the reference's: two microbatches give
    the one-batch update up to float32 accumulation."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model
    cfg = smoke_config("smollm-135m")
    _, tb = batch_pair(cfg, np.random.default_rng(2), b=4, s=32)
    out = []
    for mb in (1, 2):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        tcfg = port_step.TrainConfig(microbatches=mb, remat_policy="none")
        port_step.make_train_step(model, tcfg)(
            port_step.init_train_state(model, model.tree(), tcfg), tb)
        out.append(T.leaves(model.tree()))
    d = max(float(torch.max(torch.abs(a - b).detach())) for a, b in zip(*out))
    assert d < 5e-3, d


def test_train_state_from_reference_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float64"):
        train_state_from_reference({"opt": {"m": np.zeros(3)}}, "cpu")
