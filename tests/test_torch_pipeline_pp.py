"""The port's GPipe schedule (``train/pipeline.py``) on the CPU:
``pipeline_apply`` over meshes of 2 and 4 CPU stages equals the
sequential stack, in values and in gradients — bit for bit against the
stack run one microbatch at a time, within 1e-5 against the stack over
the whole batch (the reference's own check; the products then run at
another size).  Then against the reference's ``pipeline_apply`` over 4
simulated devices (a subprocess through ``tests/subproc.run_multidevice``,
which skips with its reason where the devices do not come up), values
and gradients within 1e-5."""
import os

import numpy as np
import pytest
import torch

from repro_torch.mesh import make_mesh
from repro_torch.train.pipeline import pipeline_apply

from subproc import run_multidevice

torch.set_num_threads(2)

M, MB, S, D = 8, 2, 4, 16


def inputs(nstages, seed=0):
    rng = np.random.default_rng(seed)
    Ws = rng.normal(0, 0.3, (nstages, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (M, MB, S, D)).astype(np.float32)
    return Ws, x


def block(w, h):
    return torch.tanh(h @ w)


def per_microbatch(ws, xm):
    outs = []
    for m in range(xm.shape[0]):
        h = xm[m]
        for s in range(ws.shape[0]):
            h = block(ws[s], h)
        outs.append(h)
    return torch.stack(outs)


def whole_batch(ws, xm):
    h = xm.reshape(-1, S, D)
    for s in range(ws.shape[0]):
        h = block(ws[s], h)
    return h.reshape(xm.shape)


def grads(fn, Ws, x, mesh=None):
    ws = torch.from_numpy(Ws).requires_grad_(True)
    xm = torch.from_numpy(x).requires_grad_(True)
    out = fn(ws, xm) if mesh is None else pipeline_apply(ws, xm, block, mesh, axis="pod")
    torch.sum(out ** 2).backward()
    return out.detach(), ws.grad, xm.grad


@pytest.mark.parametrize("nstages", [2, 4])
def test_pipeline_equals_sequential(nstages):
    Ws, x = inputs(nstages)
    mesh = make_mesh(["cpu"] * nstages, ("pod",))
    got = grads(None, Ws, x, mesh)
    for g, w in zip(got, grads(per_microbatch, Ws, x)):
        assert torch.equal(g, w)
    for g, w in zip(got, grads(whole_batch, Ws, x)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_pipeline_takes_a_tree_of_stage_params():
    """A dict of stacked leaves, on a mesh with another axis beside "pod"."""
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.normal(0, 0.3, (2, D, D)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(0, 0.1, (2, D)).astype(np.float32))}
    x = torch.from_numpy(rng.normal(0, 1, (3, MB, S, D)).astype(np.float32))
    mesh = make_mesh(["cpu"] * 4, ("b", "pod"), (2, 2))
    got = pipeline_apply(p, x, lambda sp, h: torch.tanh(h @ sp["w"] + sp["b"]), mesh)
    want = x
    for s in range(2):
        want = torch.tanh(want @ p["w"][s] + p["b"][s])
    assert torch.equal(got, want)


def test_pipeline_equals_reference(tmp_path):
    Ws, x = inputs(4)
    np.save(tmp_path / "Ws.npy", Ws)
    np.save(tmp_path / "x.npy", x)
    script = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import use_mesh
        from repro.train.pipeline import pipeline_apply

        mesh = jax.make_mesh((4,), ("pod",))
        Ws = jnp.asarray(np.load({str(tmp_path / "Ws.npy")!r}))
        x = jnp.asarray(np.load({str(tmp_path / "x.npy")!r}))

        def block(w, h):
            return jnp.tanh(h @ w)

        with use_mesh(mesh):
            out = pipeline_apply(Ws, x, block, mesh, axis="pod")
            gw, gx = jax.grad(lambda w, xm: jnp.sum(
                pipeline_apply(w, xm, block, mesh, axis="pod") ** 2), argnums=(0, 1))(Ws, x)
        for name, a in (("out", out), ("gw", gw), ("gx", gx)):
            np.save({str(tmp_path)!r} + "/ref_" + name + ".npy", np.asarray(a))
        print("PP_OK")
    """
    run_multidevice(script, token="PP_OK", devices=4, timeout=600)
    mesh = make_mesh(["cpu"] * 4, ("pod",))
    for name, got in zip(("out", "gw", "gx"), grads(None, Ws, x, mesh)):
        want = np.load(os.path.join(tmp_path, f"ref_{name}.npy"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
