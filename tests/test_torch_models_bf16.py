"""The port's bf16 compute path against the JAX reference's on the CPU:
every ``smoke_config`` arch with ``compute_dtype="bfloat16"`` (float32
parameters, the reference's own weights through
``convert.params_from_reference``), prefill of 40 tokens in a cache of 48
and 4 ``decode_step``s on the same inputs from a numpy seed.

What is held: every step's logits are float32 of the reference's shape,
within BF16_TOL of the largest |reference logit|; a greedy token may
differ only where the reference's top-2 margin is below that bound; the
caches have the reference's keys, shapes and dtypes (K/V, conv buffers
and the hybrid's ring in bf16, the recurrent states in float32) and
agree within BF16_TOL of each entry's largest |value|.

Why a tolerance and not equality: XLA fuses chains of bf16 elementwise
ops (``silu(g) * h``, the residual sums, the scans' gates) and rounds
once at the fusion's end, where eager PyTorch rounds after every op, so
the two packages' bf16 results differ by rounding.  The worst over all
archs, with these inputs, was 1.22e-2 of the largest |logit| and 1.31e-2
of a cache entry's largest |value| (both mamba2-370m, whose SSD chunk
products round most) when this file was written; the limit is about 2.3
times that, some 8 bf16 ulps of the largest value.  The float32 path is
held 300x tighter in ``test_torch_models.py``."""
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

from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models.model import build_model

torch.set_num_threads(2)

BF16_TOL = 3e-2
B, S, MAX_LEN, DECODE_STEPS = 2, 40, 48, 4
TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bf16_pair(arch, seed=0):
    """The reference and the port at smoke size in bf16 compute, holding
    the reference's weights."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), compute_dtype="bfloat16")
    rmodel = ref_build_model(rcfg, RefMeshCtx())
    params = rmodel.init(jax.random.key(seed))
    model = build_model(dataclasses.replace(smoke_config(arch), compute_dtype="bfloat16"),
                        device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), "cpu"))
    return rmodel, params, model


def inputs(cfg, rng, seq):
    if cfg.embeds_input:
        e = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def logits_close(port, ref, vocab):
    """Returns max |port - ref| / max |ref| over the vocabulary; asserts
    the bound and the greedy rule."""
    assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape
    got = port.detach().double().numpy()[:, :vocab]
    want = np.asarray(ref, np.float64)[:, :vocab]
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= BF16_TOL * scale, (err, scale)
    top2 = np.sort(want, axis=-1)[:, -2:]
    for row in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
        assert top2[row, 1] - top2[row, 0] < BF16_TOL * scale, row
    return err / scale


def cache_close(port_cache, ref_cache):
    assert port_cache["len"] == int(ref_cache["len"])
    assert set(port_cache) == set(ref_cache)
    for k, ref in ref_cache.items():
        if k == "len":
            continue
        got = port_cache[k]
        assert tuple(got.shape) == ref.shape, k
        assert got.dtype == TORCH_DTYPE[str(ref.dtype)], (k, got.dtype, ref.dtype)
        want = np.asarray(ref, np.float64)
        err = np.abs(got.detach().double().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_bf16_near_reference(arch):
    rmodel, params, model = bf16_pair(arch)
    cfg = model.cfg
    assert cfg.cdtype == torch.bfloat16
    rng = np.random.default_rng(100 + ARCHS.index(arch))
    rb, tb = inputs(cfg, rng, S)
    rlast, rcache = jax.jit(lambda p, b: rmodel.prefill(p, dict(b, max_len=MAX_LEN)))(
        params, rb)
    with torch.no_grad():
        last, cache = model.prefill(dict(tb, max_len=MAX_LEN))
    logits_close(last, rlast, cfg.vocab)
    cache_close(cache, rcache)
    rdecode = jax.jit(rmodel.decode_step)
    for _ in range(DECODE_STEPS):
        rb, tb = inputs(cfg, rng, 1)
        rlast, rcache = rdecode(params, rcache, rb)
        with torch.no_grad():
            last, cache = model.decode_step(cache, tb)
        logits_close(last, rlast, cfg.vocab)
    cache_close(cache, rcache)
