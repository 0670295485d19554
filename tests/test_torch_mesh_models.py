"""The models on a mesh: the port's shard branches (``moe.moe_ffn``'s
expert-parallel capacity form and FSDP dropless form, ``rglru._seq_scan``'s
two-level scan) and whole smoke-size models on a (4, 2) ("data", "model")
mesh of CPU devices (``repro_torch.mesh``: the CPU listed 8 times, the
shards run in turn), against the reference's ``shard_map`` branches on 8
simulated devices.

The reference's side runs once, in one subprocess
(``tests/subproc.run_multidevice``, which skips with its reason where the
devices do not come up): it draws the weights, runs every case and
writes weights, outputs and gradients to one ``.npz`` that the tests
read.  The inputs come from a numpy seed in both processes.

Tolerances: forward values within FWD_TOL (1e-5) of the largest |value|
of the reference's output; gradients within GRAD_TOL (1e-4) of each
leaf's largest |gradient|.  Both packages sum in different orders (XLA's
collectives and einsums, the port's ascending psum and its doubling
scan against the associative scan), so float32 agrees to rounding, not
bit for bit.  Readings when this file was written (worst over the
cases): MoE outputs 3.7e-7, aux 1.2e-7, the scan 1.5e-7, model logits
4.6e-7, losses 1.7e-7, gradients 8.8e-7 of their leaf's largest.

The port is also held against itself: the dropless form on the mesh
equals the unsharded ``moe_ffn`` (routing is per token), the capacity
form equals the unsharded ``moe_ffn`` applied to each dp shard's tokens
on their own (its capacity C counts each shard's own tokens), and a
sequence that does not split over the shards takes the one-scan
fallback."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.mesh import make_mesh
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models.common import MeshCtx
from repro_torch.models.model import build_model

from subproc import run_multidevice

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
DATA, MODEL = 4, 2
MOE_CASES = {"capacity_1.25": ("capacity", 1.25), "capacity_8": ("capacity", 8.0),
             "dropless": ("ragged", 1.25)}
MOE_X = (4, 16)                 # (B, S): 64 tokens, 16 per dp shard
SCAN_SHAPES = {"split": (4, 40, 64), "fallback": (4, 41, 64)}   # 41 % 2 != 0
MODEL_ARCHS = ("qwen3-moe-30b-a3b", "recurrentgemma-9b")
MODEL_BS = (4, 40)

REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.compat import use_mesh
from repro.configs import smoke_config
from repro.models import moe as MOE, rglru as RG
from repro.models.common import MeshCtx
from repro.models.model import build_model
from repro.runtime.sharding import path_str

mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape({data}, {model}), ("data", "model"))
mctx = MeshCtx(mesh=mesh, dp=("data",), fsdp="data", tp="model")
out = {{}}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + path_str(path)] = np.asarray(leaf)

for name, (impl, cf) in {moe_cases}.items():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl, capacity_factor=cf))
    p = MOE.init_moe(jax.random.key(0), cfg, jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).normal(0, 1, {moe_x} + (cfg.d_model,)), jnp.float32)
    def loss(p, x):
        o, aux = MOE.moe_ffn(p, x, cfg, mctx)
        return jnp.sum(o ** 2) + 0.01 * aux, (o, aux)
    with use_mesh(mesh):
        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
    put(f"moe/{{name}}/p/", p)
    put(f"moe/{{name}}/grad/", gp)
    out[f"moe/{{name}}/grad/x"] = np.asarray(gx)
    out[f"moe/{{name}}/out"] = np.asarray(o)
    out[f"moe/{{name}}/aux"] = np.asarray(aux)

for name, shape in {scan_shapes}.items():
    cfg = smoke_config("recurrentgemma-9b")
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.uniform(0.5, 1.0, shape), jnp.float32)
    gx = jnp.asarray(rng.normal(0, 1, shape), jnp.float32)
    with use_mesh(mesh):
        out[f"scan/{{name}}"] = np.asarray(jax.jit(lambda a, g: RG._seq_scan(a, g, cfg, mctx))(a, gx))

for arch in {archs}:
    cfg = smoke_config(arch)
    model = build_model(cfg, mctx)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(2)
    B, S = {model_bs}
    batch = {{"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}}
    with use_mesh(mesh):
        (loss, _), g = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))(params, batch)
        logits, _ = jax.jit(model.forward)(params, batch)
    put(f"model/{{arch}}/p/", params)
    put(f"model/{{arch}}/grad/", g)
    out[f"model/{{arch}}/loss"] = np.asarray(loss)
    out[f"model/{{arch}}/logits"] = np.asarray(logits)

np.savez({path!r}, **out)
print("MESH_REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    run_multidevice(REFERENCE.format(
        data=DATA, model=MODEL, moe_cases=MOE_CASES, moe_x=MOE_X, scan_shapes=SCAN_SHAPES,
        archs=MODEL_ARCHS, model_bs=MODEL_BS, path=path),
        token="MESH_REFERENCE_OK", devices=DATA * MODEL, timeout=600)
    with np.load(path) as f:
        return dict(f)


def mesh_ctx():
    return MeshCtx(mesh=make_mesh(["cpu"] * (DATA * MODEL), ("data", "model"), (DATA, MODEL)))


def tree_under(ref, prefix) -> dict:
    """The ``.npz``'s leaves under ``prefix`` as {dotted path: tensor}."""
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(prefix)}


def near(got, want, tol, what):
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    err = float((got.detach() - want).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def moe_cfg(name):
    impl, cf = MOE_CASES[name]
    cfg = smoke_config("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl,
                                                            capacity_factor=cf))


def moe_inputs(ref, name):
    p = {k: v.clone().requires_grad_(True) for k, v in tree_under(ref, f"moe/{name}/p/").items()}
    cfg = moe_cfg(name)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, MOE_X + (cfg.d_model,))
                         .astype(np.float32)).requires_grad_(True)
    return cfg, p, x


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_shard_branch_against_reference(ref, name):
    """``moe_ffn`` on the (4, 2) mesh: out and aux within FWD_TOL, the
    gradients of sum(out^2) + 0.01 aux (every weight and x) within
    GRAD_TOL.  At capacity_factor 1.25 some slots are dropped."""
    cfg, p, x = moe_inputs(ref, name)
    out, aux = MOE.moe_ffn(p, x, cfg, mesh_ctx())
    near(out, ref[f"moe/{name}/out"], FWD_TOL, "out")
    near(aux, ref[f"moe/{name}/aux"], FWD_TOL, "aux")
    loss = torch.sum(out ** 2) + 0.01 * aux
    leaves = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in leaves] + [x])
    for k, g in zip(leaves + ["x"], grads):
        near(g, ref[f"moe/{name}/grad/{k}"], GRAD_TOL, f"grad {k}")
    if name == "capacity_1.25":          # drops happen: some expert is past C in a shard
        T = MOE_X[0] * MOE_X[1] // DATA
        C = max(8, -(-T * cfg.moe.top_k * 1.25 // cfg.moe.n_experts))
        x2d = x.detach().reshape(DATA, T, cfg.d_model)
        over = [int(torch.bincount(MOE._route(x2d[d], p["router"].detach(), cfg.moe)[0],
                                   minlength=cfg.moe.n_experts).max()) > C
                for d in range(DATA)]
        assert any(over)


def test_moe_dropless_on_mesh_equals_unsharded(ref):
    """Dropless routing is per token: the mesh's output equals the
    unsharded ``moe_ffn``'s within FWD_TOL."""
    cfg, p, x = moe_inputs(ref, "dropless")
    with torch.no_grad():
        got, _ = MOE.moe_ffn(p, x, cfg, mesh_ctx())
        want, _ = MOE.moe_ffn(p, x, cfg, MeshCtx())
    near(got, want, FWD_TOL, "dropless mesh vs unsharded")


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_capacity_on_mesh_equals_unsharded_per_dp_shard(cf):
    """The capacity form on the mesh equals the unsharded ``moe_ffn`` run
    on each dp shard's tokens on its own (each shard's C from its own T),
    and its aux is the mean of those shards' aux."""
    cfg = smoke_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    g = torch.Generator().manual_seed(3)
    p = MOE.init_moe(g, cfg, torch.float32)
    x = torch.randn(MOE_X + (cfg.d_model,), generator=g)
    with torch.no_grad():
        got, aux = MOE.moe_ffn(p, x, cfg, mesh_ctx())
        parts = [MOE.moe_ffn(p, xs, cfg, MeshCtx()) for xs in x.chunk(DATA, dim=0)]
    near(got, torch.cat([o for o, _ in parts]), FWD_TOL, "capacity per dp shard")
    near(aux, torch.stack([a for _, a in parts]).mean(), FWD_TOL, "aux")


@pytest.mark.parametrize("name", list(SCAN_SHAPES))
def test_seq_scan_against_reference(ref, name):
    """The two-level scan over 2 sequence shards of 20 (and the one-scan
    fallback at S = 41) against the reference's, within FWD_TOL; the
    mesh's scan also against the port's unsharded one."""
    cfg = smoke_config("recurrentgemma-9b")
    rng = np.random.default_rng(1)
    shape = SCAN_SHAPES[name]
    a = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32))
    gx = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    h = RG._seq_scan(a, gx, cfg, mesh_ctx())
    near(h, ref[f"scan/{name}"], FWD_TOL, "scan vs reference")
    near(h, RG._seq_scan(a, gx, cfg, MeshCtx()), FWD_TOL, "scan vs unsharded")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_on_mesh_against_reference(ref, arch):
    """The smoke model on the mesh, with the reference's weights: logits
    within FWD_TOL, the loss within FWD_TOL relative, every gradient leaf
    within GRAD_TOL of its largest."""
    cfg = smoke_config(arch)
    model = build_model(cfg, mesh_ctx(), device="cpu")
    model.load_state_dict(tree_under(ref, f"model/{arch}/p/"))
    rng = np.random.default_rng(2)
    B, S = MODEL_BS
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    with torch.no_grad():
        logits, _ = model(batch)
    near(logits, ref[f"model/{arch}/logits"], FWD_TOL, "logits")
    loss, _ = model.loss_fn(batch)
    near(loss, ref[f"model/{arch}/loss"], FWD_TOL, "loss")
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = tree_under(ref, f"model/{arch}/grad/")
    assert sorted(names) == sorted(want)
    for k, g in zip(names, grads):
        near(g, want[k], GRAD_TOL, f"grad {k}")
