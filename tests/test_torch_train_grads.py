"""The port's loss and gradients against the JAX reference on the CPU, for
every ``smoke_config`` arch: the same weights (the reference's
``Model.init``, carried across by ``convert.params_from_reference``) and
the same batch from a numpy seed (S = 40: past ``attn_chunk`` = 32 and
past the hybrid's 32-position window), the port's autograd against the
reference's ``jax.value_and_grad(model.loss_fn, has_aux=True)``.

Tolerance, per gradient leaf: max |port - reference| <= GRAD_TOL x max
|reference| (1e-4), and the loss within 1e-4 relative.  Both sum in
different orders (the scans, the SSD chunk products, the einsums), so
float32 gradients agree to rounding, not bit for bit; the worst leaf
over all ten archs read 1.7e-6 of its largest |gradient|
(recurrentgemma-9b's ``lam``, through the RG-LRU scan; mamba2-370m's
``dt_bias`` 1.6e-6, the rest below 7.2e-7) and the losses 1.7e-7 when
this file was written.

Rematerialisation: for every family, the gradients under ``"full"`` and
``"dots"`` equal those under ``"none"`` bit for bit (the recomputed
forward runs the same operations on the CPU).  And the SSD's masked
exponential at mamba2-370m's published chunk (256): the reference's
gradient is not finite there, the port's is."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models.common import MeshCtx as RefMeshCtx
from repro.models.model import build_model as ref_build_model

from repro_torch import tree as T
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models.model import build_model

torch.set_num_threads(2)

GRAD_TOL = 1e-4
B, S = 2, 40
FAMILY_ARCHS = {"dense": "smollm-135m", "moe": "qwen3-moe-30b-a3b",
                "ssm": "mamba2-370m", "hybrid": "recurrentgemma-9b"}


def reference_pair(arch, seed=0, rcfg=None):
    rcfg = rcfg or ref_smoke_config(arch)
    rmodel = ref_build_model(rcfg, RefMeshCtx())
    params = rmodel.init(jax.random.key(seed))
    cfg = smoke_config(arch)
    if rcfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=rcfg.ssm.chunk))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), "cpu"))
    return rmodel, params, model


def batch_pair(cfg, rng, b=B, s=S):
    """The same training batch for both packages."""
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.embeds_input:
        x = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    x["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def port_grads(model, batch):
    """(loss, {path: grad}) by autograd over the model's parameters."""
    params = model.tree()
    flat = T.flatten_with_path(params)
    loss, _ = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, [p for _, p in flat])
    return loss.detach(), {path: g for (path, _), g in zip(flat, grads)}


def ref_grads(rmodel, params, batch):
    (loss, _), g = jax.jit(jax.value_and_grad(rmodel.loss_fn, has_aux=True))(params, batch)
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return float(loss), {tuple(k.key for k in path): np.asarray(x) for path, x in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    rmodel, params, model = reference_pair(arch)
    rb, tb = batch_pair(model.cfg, np.random.default_rng(ARCHS.index(arch) + 100))
    rloss, rg = ref_grads(rmodel, params, rb)
    loss, g = port_grads(model, tb)
    assert abs(float(loss) - rloss) <= 1e-4 * abs(rloss)
    assert set(g) == set(rg)
    for path, want in rg.items():
        got = g[path].numpy()
        assert got.shape == want.shape, path
        assert np.all(np.isfinite(got)), path
        scale = float(np.max(np.abs(want)))
        err = float(np.max(np.abs(got - want)))
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_grads_equal_no_remat(family, policy):
    arch = FAMILY_ARCHS[family]
    cfg = smoke_config(arch)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    _, tb = batch_pair(cfg, np.random.default_rng(8))
    loss0, g0 = port_grads(model, tb)
    model.remat_policy = policy
    loss1, g1 = port_grads(model, tb)
    assert torch.equal(loss0, loss1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


def test_remat_policy_is_checked():
    model = build_model(smoke_config("smollm-135m"), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model.remat_policy = "some"
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(smoke_config("smollm-135m"), device="cpu", remat_policy="all")


def test_remat_full_recomputes_the_blocks():
    """Under "full" a block keeps no activation: the backward pass runs
    each block's forward again (counted through a hook on rms_norm's
    module-level name), and "none" runs it once."""
    from repro_torch.models import layers as L
    cfg = smoke_config("smollm-135m")
    model = build_model(cfg, device="cpu")
    _, tb = batch_pair(cfg, np.random.default_rng(9))
    calls = []
    orig = L.rms_norm

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    for policy, want in (("none", 1), ("full", 2), ("dots", 2)):
        model.remat_policy = policy
        L.rms_norm = counted
        try:
            calls.clear()
            port_grads(model, tb)
        finally:
            L.rms_norm = orig
        # two norms a block, plus the final norm once
        assert len(calls) == want * 2 * cfg.n_layers + 1, (policy, len(calls))


def test_ssd_masked_exp_at_the_published_chunk():
    """mamba2-370m's SSMCfg.chunk (256) at smoke widths with S = 256: the
    segment sums above the diagonal overflow exp.  The reference takes
    exp(seg) and masks after, so its backward is 0 * inf = NaN; the port
    masks seg to -inf first.  The losses agree, the port's gradients are
    finite and the reference's are not (a reference caveat, ROADMAP
    Queue 3)."""
    from repro.models.common import SSMCfg as RefSSMCfg
    from repro_torch.configs import get_config
    chunk = get_config("mamba2-370m").ssm.chunk
    assert chunk == 256
    rcfg = ref_smoke_config("mamba2-370m")
    rcfg = dataclasses.replace(rcfg, ssm=dataclasses.replace(rcfg.ssm, chunk=chunk))
    assert isinstance(rcfg.ssm, RefSSMCfg)
    rmodel, params, model = reference_pair("mamba2-370m", rcfg=rcfg)
    assert model.cfg.ssm.chunk == chunk
    rb, tb = batch_pair(model.cfg, np.random.default_rng(10), s=chunk)
    rloss, rg = ref_grads(rmodel, params, rb)
    loss, g = port_grads(model, tb)
    assert abs(float(loss) - rloss) <= 1e-4 * abs(rloss)
    assert not all(np.all(np.isfinite(x)) for x in rg.values())
    assert all(bool(torch.all(torch.isfinite(x))) for x in g.values())
    # where the reference's gradient is finite, the two agree
    for path, want in rg.items():
        if np.all(np.isfinite(want)):
            scale = float(np.max(np.abs(want)))
            assert float(np.max(np.abs(g[path].numpy() - want))) <= GRAD_TOL * scale, path
