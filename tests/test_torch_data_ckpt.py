"""The port's data pipeline and checkpoints against the reference's on
the CPU.  ``TokenPipeline.batch_at`` equals the reference's bit for bit
over seeds, shard counts and steps.  A train state (params, float32 or
int8 moments, the int8_ef error, the int32 step) saved by the reference
restores exactly in the port, and one saved by the port restores exactly
in the reference; the two manifests agree in keys, shapes, dtypes and
shas.  The reference's own cases on the port: a corrupted newest
checkpoint falls back to the one before, ``AsyncCheckpointer`` keeps the
newest ``keep`` (3 by default)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.data import pipeline as ref_data
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step

from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import train_state_from_reference
from repro_torch.data import pipeline as data

from test_torch_train_grads import reference_pair


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_batches_equal_reference(seed, num_shards):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=seed)
    for shard in range(num_shards):
        got = data.TokenPipeline(data.DataConfig(**kw), shard, num_shards)
        want = ref_data.TokenPipeline(ref_data.DataConfig(**kw), shard, num_shards)
        for step in (0, 1, 5, 123):
            a, b = got.batch_at(step), want.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    it = iter(data.TokenPipeline(data.DataConfig(**kw)))
    np.testing.assert_array_equal(next(it)["tokens"], data.TokenPipeline(
        data.DataConfig(**kw)).batch_at(0)["tokens"])


def test_pipeline_determinism_sharding_resume():
    dc = data.DataConfig(vocab=128, seq_len=16, global_batch=8, seed=7)
    a = data.TokenPipeline(dc, shard_id=0, num_shards=2)
    b = data.TokenPipeline(dc, shard_id=1, num_shards=2)
    assert np.array_equal(a.batch_at(5)["tokens"], a.batch_at(5)["tokens"])
    assert not np.array_equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])
    assert a.batch_at(5)["tokens"].shape == (4, 16)
    full = data.TokenPipeline(dc).batch_at(0)
    assert np.array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])


def train_trees(moments, compression):
    """The reference's {"params", "state"} after one step, and the port's
    copy of it."""
    opt = ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                                moments_dtype=moments)
    rc = ref_step.TrainConfig(opt=opt, remat_policy="none", grad_compression=compression)
    rmodel, params, _ = reference_pair("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(1)
    batch = {k: jnp.asarray(rng.integers(0, 256, (2, 16)), jnp.int32)
             for k in ("tokens", "labels")}
    params, state, _ = jax.jit(ref_step.make_train_step(rmodel, rc))(
        params, ref_step.init_train_state(rmodel, params, rc), batch)
    tree = jax.tree.map(np.asarray, {"params": params, "state": state})
    return tree, train_state_from_reference(tree, "cpu")


def same_tree(port, ref_tree):
    pf = T.flatten_with_path(port)
    rf = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [T.keystr(p) for p, _ in pf] == [jax.tree_util.keystr(p) for p, _ in rf]
    for (_, a), (_, b) in zip(pf, rf):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("moments,compression", [("float32", "none"), ("int8", "int8_ef")])
def test_checkpoints_cross_packages(tmp_path, moments, compression):
    ref_tree, port_tree = train_trees(moments, compression)
    dtypes = {str(np.asarray(x).dtype) for x in jax.tree.leaves(ref_tree)}
    assert dtypes == ({"float32", "int32", "int8"} if moments == "int8"
                      else {"float32", "int32"})

    # the reference saves, the port restores
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rpath = ref_ckpt.save(rdir, 3, ref_tree)
    target = T.map_tree(torch.zeros_like, port_tree)
    step, got = ckpt.restore(rdir, target)
    assert step == 3
    same_tree(got, ref_tree)

    # the port saves, the reference restores
    ppath = ckpt.save(pdir, 3, port_tree)
    step, back = ref_ckpt.restore(pdir, jax.tree.map(jnp.zeros_like, ref_tree))
    assert step == 3
    same_tree(port_tree, jax.tree.map(np.asarray, back))

    # the same files: keys, shapes, dtypes, shas
    assert os.path.basename(ppath) == os.path.basename(rpath) == "step_000000003"
    assert manifest(ppath) == manifest(rpath)
    assert sorted(os.listdir(ppath)) == sorted(os.listdir(rpath))


def test_restore_places_leaves(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3), "s": torch.tensor(4.0)}
    ckpt.save(str(tmp_path), 1, tree)
    step, got = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 1 and got["s"].shape == () and got["a"].dtype == torch.int32
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["s"], tree["s"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), tree, step=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)
    assert ckpt.restore_latest(str(tmp_path / "none"), tree) is None
    # a target the checkpoint lacks a leaf of is not restored
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), dict(tree, extra=torch.zeros(1)))


def test_bfloat16_leaf_round_trip(tmp_path):
    """The port writes a bfloat16 leaf as its uint16 bit pattern with the
    dtype named in the manifest, and restores it as bfloat16."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    path = ckpt.save(str(tmp_path), 2, {"w": x})
    leaf = manifest(path)["leaves"][0]
    assert leaf["dtype"] == "bfloat16" and leaf["key"] == "['w']"
    assert np.load(os.path.join(path, leaf["file"])).dtype == np.uint16
    _, got = ckpt.restore(str(tmp_path), {"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)


def test_corrupted_newest_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(8, dtype=torch.float32), "b": {"c": torch.ones((3, 3))}}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, T.map_tree(lambda x: x * 2, tree))
    s, restored = ckpt.restore(d, tree)
    assert s == 2 and torch.equal(restored["a"], tree["a"] * 2)
    with open(os.path.join(d, "step_000000002", "leaf_0.npy"), "wb") as f:
        f.write(b"garbage")
    s, restored = ckpt.restore(d, tree)
    assert s == 1 and torch.equal(restored["a"], tree["a"])
    # a manifest that is not JSON is skipped too
    with open(os.path.join(d, "step_000000001", "manifest.json"), "w") as f:
        f.write("{")
    assert ckpt.restore_latest(d, tree) is None


@pytest.mark.parametrize("keep", [2, 3])
def test_async_checkpointer_keeps_the_newest(tmp_path, keep):
    d = str(tmp_path / "ck")
    saver = ckpt.AsyncCheckpointer(d) if keep == 3 else ckpt.AsyncCheckpointer(d, keep=keep)
    w = torch.ones(4)
    for s in (1, 2, 3, 4, 5):
        saver.save_async(s, {"w": w})
        w.mul_(2)          # the snapshot was taken before the thread started
    saver.wait()
    assert ckpt.list_steps(d) == list(range(6 - keep, 6))
    _, got = ckpt.restore(d, {"w": w})
    assert torch.equal(got["w"], torch.full((4,), 16.0))
