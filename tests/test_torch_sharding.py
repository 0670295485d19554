"""The port's sharding rules (``runtime/sharding.py``), its production
meshes (``launch/mesh.py``), its ``NamedSharding`` and the sharded
checkpoint restore, against the reference.

Specs: for each of the ten archs at their published widths, every
leaf's spec of ``param_pspecs``, ``opt_pspecs`` (float32 and int8
moments), ``batch_pspecs`` (the dry run's inputs of every ``SHAPES``
cell) and ``cache_pspecs`` (``SHAPES``' decode cells) equals the
reference's, element for element, on pod1 (16 x 16), pod2 (2 x 16 x 16)
and a (4, 2) mesh.  The port's shapes come from a ``meta`` build (no
weights drawn), the reference's from ``jax.eval_shape``; its rules read
only ``mesh.shape``, so a stand-in with that dict serves as its mesh.

Blocks and checkpoints against the reference on 8 simulated devices, in
one subprocess (``tests/subproc.run_multidevice``, which skips with its
reason where the devices do not come up) writing one ``.npz``:
``NamedSharding.shard_shape`` and each shard's slices against the
reference's ``shard_shape`` and ``devices_indices_map`` on a (4, 2)
mesh; a port checkpoint restored by the reference under the specs of
that mesh (each shard's data equal to the port's block, bit for bit)
and a checkpoint the reference wrote from sharded arrays restored by the
port under its specs (bit for bit, on the mesh's first device)."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.common import SHAPES as REF_SHAPES
from repro.models.common import MeshCtx as RefMeshCtx
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.runtime import sharding as RSH

from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch.mesh import make_mesh_ctx, make_production_mesh
from repro_torch.mesh import NamedSharding, P, make_mesh
from repro_torch.models.common import SHAPES, MeshCtx
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime import sharding as SH

from subproc import run_multidevice

torch.set_num_threads(2)

MESHES = {
    "pod1": ({"data": 16, "model": 16}, ("data",)),
    "pod2": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
    "4x2": ({"data": 4, "model": 2}, ("data",)),
}
DECODE_CELLS = [k for k, s in SHAPES.items() if s.kind == "decode"]


def port_ctx(mesh_name) -> MeshCtx:
    if mesh_name == "4x2":
        return MeshCtx(mesh=make_mesh(["cpu"] * 8, ("data", "model"), (4, 2)))
    return make_mesh_ctx(multi_pod=mesh_name == "pod2", devices=["cpu"] * 512)


def ref_ctx(mesh_name) -> RefMeshCtx:
    shape, dp = MESHES[mesh_name]
    return RefMeshCtx(mesh=types.SimpleNamespace(shape=shape), dp=dp)


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    """The reference's parameter, optimizer and decode-cache shapes."""
    model = ref_build_model(ref_get_config(arch), RefMeshCtx())
    pshapes = jax.eval_shape(model.init, jax.random.key(0))
    opt = {md: jax.eval_shape(lambda p: ref_init_opt_state(p, RefAdamWConfig(moments_dtype=md)),
                              pshapes) for md in ("float32", "int8")}
    caches = {c: jax.eval_shape(lambda: model.init_cache(REF_SHAPES[c].batch, REF_SHAPES[c].seq))
              for c in DECODE_CELLS}
    return pshapes, opt, caches


@functools.lru_cache(maxsize=None)
def port_shapes(arch):
    """The port's, from a build on ``meta``."""
    model = build_model(get_config(arch), device="meta")
    params = model.tree()
    opt = {md: init_opt_state(params, AdamWConfig(moments_dtype=md))
           for md in ("float32", "int8")}
    caches = {c: model.init_cache(SHAPES[c].batch, SHAPES[c].seq) for c in DECODE_CELLS}
    return params, opt, caches


def batch_trees(cfg):
    """The dry run's inputs of every cell, as (name, port tree, reference
    tree): meta tensors and ``jax.ShapeDtypeStruct``s of equal shapes."""
    out = []
    for name, shape in SHAPES.items():
        B, S = shape.batch, (1 if shape.kind == "decode" else shape.seq)
        leaves = {}
        if shape.kind == "train":
            leaves["labels"] = (B, S)
        leaves["embeds" if cfg.embeds_input else "tokens"] = (
            (B, S, cfg.d_model) if cfg.embeds_input else (B, S))
        out.append((name, {k: torch.empty(v, device="meta") for k, v in leaves.items()},
                    {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in leaves.items()}))
    return out


def same_specs(port, ref, what):
    """Every leaf's spec equal, element for element, at the same path."""
    want = {RSH.path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = {SH.path_str(p): s for p, s in T.flatten_with_path(port)}
    assert sorted(got) == sorted(want), what
    for k in want:
        assert isinstance(got[k], P), (what, k)
        assert tuple(got[k]) == tuple(want[k]), f"{what} {k}: {got[k]} != {want[k]}"


def test_meta_build_matches_eval_shape():
    """``build_model(cfg, device="meta")`` for all ten archs: every leaf's
    shape and dtype equal to the reference's ``eval_shape``, nothing
    allocated; ``init_cache`` works there too."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for arch in ARCHS:
        params, _, caches = port_shapes(arch)
        pshapes = ref_shapes(arch)[0]
        want = {jax.tree_util.keystr(p): l for p, l in
                jax.tree_util.tree_flatten_with_path(pshapes)[0]}
        got = {T.keystr(p): l for p, l in T.flatten_with_path(params)}
        assert sorted(got) == sorted(want), arch
        for k, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == want[k].shape, (arch, k)
            assert str(leaf.dtype).removeprefix("torch.") == str(want[k].dtype), (arch, k)
        for c in DECODE_CELLS:
            rc = ref_shapes(arch)[2][c]
            for path, leaf in T.flatten_with_path(caches[c]):
                if path == ("len",):
                    continue
                r = rc
                for key in path:
                    r = r[key]
                assert tuple(leaf.shape) == r.shape and leaf.device.type == "meta", (arch, c, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mesh_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mctx, rctx = port_ctx(mesh_name), ref_ctx(mesh_name)
    params, opt, caches = port_shapes(arch)
    pshapes, ropt, rcaches = ref_shapes(arch)
    pspecs = SH.param_pspecs(params, cfg, mctx)
    rpspecs = RSH.param_pspecs(pshapes, rcfg, rctx)
    same_specs(pspecs, rpspecs, "params")
    for md in ("float32", "int8"):
        same_specs(SH.opt_pspecs(pspecs, opt[md], mctx, md),
                   RSH.opt_pspecs(rpspecs, ropt[md], rctx, md), f"opt {md}")
    for name, pb, rb in batch_trees(cfg):
        same_specs(SH.batch_pspecs(pb, mctx), RSH.batch_pspecs(rb, rctx), f"batch {name}")
    for c in DECODE_CELLS:
        same_specs(SH.cache_pspecs(caches[c], cfg, mctx),
                   RSH.cache_pspecs(rcaches[c], rcfg, rctx), f"cache {c}")
    # every spec names axes of the mesh and divides its leaf
    for path, s in T.flatten_with_path(pspecs):
        leaf = dict(T.flatten_with_path(params))[path]
        NamedSharding(mctx.mesh, s).shard_shape(leaf.shape)


def test_production_meshes():
    """pod1 and pod2 over a repeated device, the reference's roles; with
    too few devices (no card here) they raise and name ``devices=``."""
    m1 = make_production_mesh(devices=["cpu"] * 300)
    assert m1.shape == {"data": 16, "model": 16} and len(m1.devices) == 256
    ctx2 = make_mesh_ctx(multi_pod=True, devices=["cpu"] * 512)
    assert ctx2.mesh.axis_names == ("pod", "data", "model")
    assert (ctx2.dp, ctx2.fsdp, ctx2.tp, ctx2.sp) == (("pod", "data"), "data", "model", "model")
    assert make_mesh_ctx(devices=["cpu"] * 256).dp == ("data",)
    with pytest.raises(RuntimeError, match="devices="):
        make_production_mesh(devices=["cpu"] * 255)
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh_ctx()


# ---------------------------------------------- against 8 simulated devices

BLOCK_CASES = [((8, 6), ("data", "model")), ((8, 6), (("data", "model"), None)),
               ((16, 4, 6), (None, "data", "model")), ((8, 8), ("model",)),
               ((8, 4), (("model", "data"),)), ((5, 3), ()), ((4, 8, 2), (None, None, "model"))]
CKPT_ARCH = "qwen3-moe-30b-a3b"

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import checkpoint as ckpt
from repro.configs import smoke_config
from repro.models.common import MeshCtx
from repro.models.model import build_model
from repro.runtime import sharding as SH

mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
order = list(mesh.devices.flat)
out = {{}}
for c, (shape, spec) in enumerate({cases}):
    sh = NamedSharding(mesh, P(*spec))
    out[f"block/{{c}}/shape"] = np.array(sh.shard_shape(shape))
    idx = sh.devices_indices_map(shape)
    out[f"block/{{c}}/slices"] = np.array(
        [[(s.start or 0, shape[d] if s.stop is None else s.stop) for d, s in enumerate(idx[dev])]
         for dev in order])

cfg = smoke_config({arch!r})
mctx = MeshCtx(mesh=mesh)
model = build_model(cfg, mctx)
pshapes = jax.eval_shape(model.init, jax.random.key(0))
shard = SH.to_named(SH.param_pspecs(pshapes, cfg, mctx), mesh)

# a port checkpoint restored under the mesh's specs
step, tree = ckpt.restore({port_dir!r}, {{"params": jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), pshapes)}},
                          shardings={{"params": shard}})
for path, x in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
    k = SH.path_str(path)
    out[f"restored/{{k}}"] = np.asarray(x)
    by_dev = {{s.device: np.asarray(s.data) for s in x.addressable_shards}}
    for i, dev in enumerate(order):
        out[f"shard/{{k}}/{{i}}"] = by_dev[dev]

# a checkpoint written from sharded arrays
params = jax.device_put(model.init(jax.random.key(1)), shard)
ckpt.save({ref_dir!r}, 7, {{"params": params}})
for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
    out[f"written/{{SH.path_str(path)}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("SHARDING_REFERENCE_OK")
"""


def port_ckpt_tree(seed=5):
    model = build_model(smoke_config(CKPT_ARCH), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return {"params": T.map_tree(lambda v: v.detach(), model.tree())}


def mesh_4x2() -> MeshCtx:
    return port_ctx("4x2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharding_ref")
    port_dir, ref_dir = str(base / "port_ckpt"), str(base / "ref_ckpt")
    ckpt.save(port_dir, 3, port_ckpt_tree())
    path = str(base / "ref.npz")
    run_multidevice(REFERENCE.format(cases=BLOCK_CASES, arch=CKPT_ARCH, port_dir=port_dir,
                                     ref_dir=ref_dir, path=path),
                    token="SHARDING_REFERENCE_OK", devices=8, timeout=600)
    with np.load(path) as f:
        data = dict(f)
    return data, ref_dir


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_blocks_against_reference(ref, case):
    """shard_shape, each shard's slices and ``blocks`` (views of the
    tensor at those slices, on the shard's device) against the
    reference's sharding of the same shape on a (4, 2) mesh."""
    data, _ = ref
    shape, spec = BLOCK_CASES[case]
    sh = NamedSharding(mesh_4x2().mesh, P(*spec))
    assert sh.shard_shape(shape) == tuple(data[f"block/{case}/shape"])
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    for i, (want, blk) in enumerate(zip(data[f"block/{case}/slices"], sh.blocks(x))):
        got = [(s.start, s.stop) for s in sh.index(i, shape)]
        assert got == [tuple(int(v) for v in w) for w in want], (i, got)
        assert torch.equal(blk, x[sh.index(i, shape)])
    assert torch.equal(sh.assemble(sh.blocks(x), "cpu"), x)


def test_checkpoint_reshards_both_ways(ref):
    """The port's checkpoint (written without a mesh) restored by the
    reference under the (4, 2) mesh's specs: whole values and every
    shard's data bit for bit (the shards the port's ``blocks`` cut).  The
    reference's checkpoint (written from arrays sharded on that mesh)
    restored by the port under its specs: bit for bit, each leaf on the
    mesh's first device, and under no mesh as well."""
    data, ref_dir = ref
    mctx = mesh_4x2()
    cfg = smoke_config(CKPT_ARCH)
    mine = port_ckpt_tree()["params"]
    specs = SH.param_pspecs(mine, cfg, mctx)
    shard = SH.to_named(specs, mctx.mesh)
    for path, x in T.flatten_with_path(mine):
        k = SH.path_str(path)
        assert np.array_equal(data[f"restored/{k}"], x.numpy()), k
        for i, blk in enumerate(dict(T.flatten_with_path(shard))[path].blocks(x)):
            assert np.array_equal(data[f"shard/{k}/{i}"], blk.numpy()), (k, i)

    target = {"params": port_ckpt_tree(seed=6)["params"]}
    step, back = ckpt.restore(ref_dir, target, shardings={"params": shard})
    step0, back0 = ckpt.restore(ref_dir, target, device="cpu")
    assert step == step0 == 7
    for path, x in T.flatten_with_path(back["params"]):
        want = data[f"written/{SH.path_str(path)}"]
        assert np.array_equal(x.numpy(), want) and x.device == mctx.mesh.devices[0]
        assert np.array_equal(dict(T.flatten_with_path(back0["params"]))[path].numpy(), want)


def test_restore_sharded_within_the_port(tmp_path):
    """A checkpoint written from a mesh model restores under another
    mesh's specs, under none, and a ``None`` sharding leaf goes to
    ``device``: bit for bit each time."""
    tree = port_ckpt_tree(seed=9)
    ckpt.save(str(tmp_path), 1, tree)
    cfg = smoke_config(CKPT_ARCH)
    mctx = MeshCtx(mesh=make_mesh(["cpu"] * 4, ("data", "model"), (2, 2)))
    shard = SH.to_named(SH.param_pspecs(tree["params"], cfg, mctx), mctx.mesh)
    shard["ln_f"] = {"w": None}
    _, back = ckpt.restore(str(tmp_path), port_ckpt_tree(seed=1), shardings={"params": shard},
                           device="cpu")
    for (p, a), (_, b) in zip(T.flatten_with_path(back), T.flatten_with_path(tree)):
        assert torch.equal(a, b), p
