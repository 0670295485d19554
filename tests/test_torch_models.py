"""The port's model substrate against the JAX reference on the CPU, at
float32 with the reference's own weights (its ``Model.init`` carried
across by ``convert.params_from_reference``) and the same inputs from a
numpy seed: for every ``smoke_config`` arch, ``forward`` logits,
``loss_fn``, ``prefill`` logits and cache, and 4 ``decode_step``s
(prompts of 40 tokens: past ``attn_chunk`` = 32 and past the hybrid's
32-position window, in a cache of 48).

Tolerance: |port - reference| <= ATOL + RTOL * |reference| elementwise
(both 1e-4).  XLA and torch sum in different orders (the einsums, the
RG-LRU's associative scan against the port's doubling scan, the SSD
chunk products), so float32 results agree to rounding, not bit for bit;
the worst difference over all archs was 1.2e-6 on logits of magnitude
up to 1.3 when this file was written.  The units (layers, routing, the
scans, the hybrid ring) are in ``test_torch_model_units.py``."""
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

from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models.model import build_model, padded_vocab

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
B, S, MAX_LEN, DECODE_STEPS = 2, 40, 48, 4


def close(port, ref):
    np.testing.assert_allclose(port.detach().double().numpy(),
                               np.asarray(ref, np.float64), atol=ATOL, rtol=RTOL)


def reference_pair(arch, seed=0):
    """The reference's model and weights for ``arch`` at smoke size, and
    the port's model holding the same weights on the CPU."""
    rcfg = ref_smoke_config(arch)
    rmodel = ref_build_model(rcfg, RefMeshCtx())
    params = rmodel.init(jax.random.key(seed))
    model = build_model(smoke_config(arch), device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), "cpu"))
    return rmodel, params, model


def inputs(cfg, rng, seq):
    """The same batch for both packages: tokens, or embeddings for an
    ``embeds_input`` arch."""
    if cfg.embeds_input:
        e = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def cache_close(port_cache, ref_cache):
    assert port_cache["len"] == int(ref_cache["len"])
    assert set(port_cache) == set(ref_cache)
    for k in ref_cache:
        if k != "len":
            assert tuple(port_cache[k].shape) == ref_cache[k].shape, k
            close(port_cache[k], ref_cache[k])


# ------------------------------------------------------------- archs

def test_configs_equal_reference():
    from repro.configs import get_config as ref_get_config
    for arch in ARCHS + ["sce-ntt"]:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch)), arch
    for arch in ARCHS:
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke_config(arch)), arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_equals_reference(arch):
    rmodel, params, model = reference_pair(arch)
    cfg = model.cfg
    rng = np.random.default_rng(ARCHS.index(arch))
    rb, tb = inputs(cfg, rng, S)
    labels = rng.integers(-1, cfg.vocab, (B, S)).astype(np.int32)

    # one reference program for forward, loss and prefill (one compile)
    (rlogits, raux), (rloss, _), (rlast, rcache) = jax.jit(
        lambda p, b: (rmodel.forward(p, b), rmodel.loss_fn(p, b),
                      rmodel.prefill(p, dict(b, max_len=MAX_LEN))))(
            params, dict(rb, labels=jnp.asarray(labels)))
    with torch.no_grad():
        logits, aux = model(tb)
        loss, _ = model.loss_fn(dict(tb, labels=torch.from_numpy(labels)))
    assert logits.shape == (B, S, padded_vocab(cfg))
    close(logits, rlogits)
    close(aux["moe_aux"], raux["moe_aux"])
    close(loss, rloss)

    last, cache = model.prefill(dict(tb, max_len=MAX_LEN))
    close(last, rlast)
    cache_close(cache, rcache)
    rdecode = jax.jit(rmodel.decode_step)
    for _ in range(DECODE_STEPS):
        rb, tb = inputs(cfg, rng, 1)
        rlast, rcache = rdecode(params, rcache, rb)
        last, cache = model.decode_step(cache, tb)
        close(last, rlast)
    cache_close(cache, rcache)
