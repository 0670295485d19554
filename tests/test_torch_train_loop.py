"""The port's training loop (``train/loop.py``) on the CPU: stopped at
step 4 and resumed to 8 it equals a straight run of 8 bit for bit
(losses, params, state); from the reference's init its 8 losses follow
the reference loop's within LOSS_TOL; and the train-then-serve round
trip across the packages (the reference's ``test_train_then_serve_
roundtrip``): the reference trains smoke smollm-135m for 8 steps and
checkpoints, the port restores that checkpoint and its ``ServeEngine``
returns the reference engine's greedy tokens on the same requests.

LOSS_TOL (1e-4 relative): the two runs start from the same weights and
batches, and their steps agree to float32 rounding (the gradients'
1e-4), so the losses of 8 steps stay within it; the largest gap read
1.7e-7 when this file was written."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models.common import MeshCtx as RefMeshCtx
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.serve.engine import Request as RefRequest, ServeEngine as RefServeEngine
from repro.train.loop import LoopConfig as RefLoopConfig, train_loop as ref_train_loop
from repro.train.step import TrainConfig as RefTrainConfig

from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, init_train_state

torch.set_num_threads(2)

LOSS_TOL = 1e-4
ARCH = "smollm-135m"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=8, schedule="wsd")
DATA = dict(seq_len=32, global_batch=4)


def port_configs(tmp, steps, remat="none"):
    cfg = smoke_config(ARCH)
    return (cfg, TrainConfig(opt=AdamWConfig(**OPT), remat_policy=remat),
            LoopConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp)),
            DataConfig(vocab=cfg.vocab, **DATA))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_resume_equals_straight_run(tmp_path, remat):
    cfg, tcfg, lcfg, dcfg = port_configs(tmp_path / "a", 8, remat)
    model = build_model(cfg, device="cpu")
    p_full, s_full, losses = train_loop(model, tcfg, lcfg, dcfg, seed=5, verbose=False)
    p_full = T.map_tree(lambda x: x.detach().clone(), p_full)
    assert losses[-1] < losses[0]
    assert ckpt.list_steps(str(tmp_path / "a")) == [4, 8]

    _, _, lcfg4, _ = port_configs(tmp_path / "b", 4, remat)
    resumed = build_model(cfg, device="cpu")
    _, _, first = train_loop(resumed, tcfg, lcfg4, dcfg, seed=5, verbose=False)
    _, _, lcfg8, _ = port_configs(tmp_path / "b", 8, remat)
    again = build_model(cfg, device="cpu")       # a fresh process's model
    p_res, s_res, rest = train_loop(again, tcfg, lcfg8, dcfg, seed=5, verbose=False)
    assert first + rest == losses
    for a, b in zip(T.leaves(p_full), T.leaves(p_res)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(s_full), T.leaves(s_res)):
        assert torch.equal(a, b)


def test_seed_draws_the_weights(tmp_path):
    """Without keep_weights the loop draws its weights from its seed, so
    two models with other weights train alike; with it, it keeps them."""
    cfg, tcfg, _, dcfg = port_configs(tmp_path, 1)
    runs = []
    for i, gen_seed in enumerate((1, 2)):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(gen_seed))
        lcfg = LoopConfig(steps=1, ckpt_every=4, ckpt_dir=str(tmp_path / f"s{i}"))
        runs.append(train_loop(model, tcfg, lcfg, dcfg, seed=9, verbose=False)[2])
    assert runs[0] == runs[1]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    lcfg = LoopConfig(steps=1, ckpt_every=4, ckpt_dir=str(tmp_path / "k"))
    assert train_loop(model, tcfg, lcfg, dcfg, seed=9, verbose=False,
                      keep_weights=True)[2] != runs[0]


def reference_run(tmp):
    """The reference's loop over 8 steps (checkpoints every 4 in ``tmp``):
    its model, params and losses, and its init's weights."""
    rcfg = ref_smoke_config(ARCH)
    rmodel = ref_build_model(rcfg, RefMeshCtx())
    init = jax.tree.map(np.asarray, rmodel.init(jax.random.key(0)))
    params, _, losses = ref_train_loop(
        rmodel, RefTrainConfig(opt=RefAdamWConfig(**OPT), remat_policy="none"),
        RefLoopConfig(steps=8, ckpt_every=4, ckpt_dir=str(tmp)),
        RefDataConfig(vocab=rcfg.vocab, **DATA), seed=0, verbose=False)
    return rmodel, params, losses, init


@pytest.fixture(scope="module")
def ref_trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_ck")
    return (tmp,) + reference_run(tmp)


def test_losses_follow_reference(tmp_path, ref_trained):
    _, _, _, rlosses, init = ref_trained
    cfg, tcfg, lcfg, dcfg = port_configs(tmp_path, 8)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(init, "cpu"))
    _, _, losses = train_loop(model, tcfg, lcfg, dcfg, verbose=False, keep_weights=True)
    assert len(losses) == len(rlosses) == 8
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_TOL, atol=0)
    assert losses[-1] < losses[0]


def test_train_then_serve_across_packages(ref_trained):
    """The reference trains and checkpoints; the port restores the
    checkpoint and serves the reference engine's tokens."""
    tmp, rmodel, rparams, _, _ = ref_trained
    cfg, tcfg, _, _ = port_configs(tmp, 8)
    model = build_model(cfg, device="cpu")
    target = {"params": model.tree(), "state": init_train_state(model, model.tree(), tcfg)}
    step, restored = ckpt.restore(str(tmp), target)
    assert step == 8
    model.load_state_dict({".".join(p): v for p, v in T.flatten_with_path(restored["params"])})
    for a, (_, b) in zip(T.leaves(model.tree()),
                         jax.tree_util.tree_flatten_with_path(rparams)[0]):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert int(restored["state"]["opt"]["step"]) == 8

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (8, 5, 11)]
    want = RefServeEngine(rmodel, rparams, batch_size=2, max_len=48).run(
        [RefRequest(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    got = ServeEngine(model, batch_size=2, max_len=48).run(
        [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    assert sorted(got) == [0, 1, 2]
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
