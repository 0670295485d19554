"""Units of the port's model substrate against the JAX reference on the
CPU (float32; the same inputs from a numpy seed): RoPE's split halves,
attention over q-chunks with every mask term (window, kv_len, non-causal,
GQA), the three MLP activations (gelu in its tanh form), MoE routing (the
experts chosen and their stable order exactly equal) and both expert
paths (capacity with drops, dropless), the chunked SSD against a
step-by-step recurrence, the RG-LRU scan against a loop, and the
hybrid's attention ring past its window; also `build_model`, the
weight loader and the refusals.  The arch-level parity and the shared
helpers are in ``test_torch_models.py``; the tolerance is the one stated
there unless a case states its own."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import rglru as RRG
from repro.models import ssm as RSSM
from repro.models.common import MeshCtx as RefMeshCtx
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.common import MeshCtx, truncated_normal_init
from repro_torch.models.model import build_model

from test_torch_models import cache_close, close, inputs, reference_pair

torch.set_num_threads(2)


def test_build_model_draws_from_the_generator():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.moe.w_up"], sc["blocks.moe.w_up"])
    # the same keys and shapes as the reference's tree
    rmodel = ref_build_model(ref_smoke_config("qwen3-moe-30b-a3b"), RefMeshCtx())
    shapes = jax.eval_shape(rmodel.init, jax.random.key(0))
    want = params_from_reference(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
    assert {k: tuple(v.shape) for k, v in sa.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_truncated_normal_init_stays_in_two_sigma():
    g = torch.Generator().manual_seed(0)
    t = truncated_normal_init(g, (4096,), torch.bfloat16, 0.02)
    assert t.dtype == torch.bfloat16
    assert float(t.float().abs().max()) <= 0.04 + 1e-4
    assert 0.01 < float(t.float().std()) < 0.02


def test_remat_and_mesh_are_refused():
    """A remat policy other than the reference's three is refused (the
    three run since the training slice), and so is a mesh."""
    from repro_torch.models.model import Model
    cfg = smoke_config("smollm-135m")
    with pytest.raises(ValueError, match="remat_policy"):
        Model(cfg, remat_policy="everything", device="cpu")
    for policy in ("none", "full", "dots"):
        assert Model(cfg, remat_policy=policy, device="cpu").remat_policy == policy
    with pytest.raises(NotImplementedError, match="one device"):
        MeshCtx(mesh=object())
    x = torch.ones(2)
    assert MeshCtx().constrain(x, "data", None) is x


def test_params_from_reference_refuses_integers_and_keeps_bf16():
    with pytest.raises(TypeError, match="not a float array"):
        params_from_reference({"w": np.zeros(3, np.uint32)}, "cpu")
    bf = np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16))
    out = params_from_reference({"a": {"b": bf}}, "cpu")
    assert out["a.b"].dtype == torch.bfloat16
    assert out["a.b"].tolist() == [1.5, -2.0]
    assert params_from_reference({"w": bf}, "cpu", torch.float32)["w"].dtype == torch.float32


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke_config("smollm-135m"))


def test_rope_equals_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [100]])).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    close(got, RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    # split halves: position 1 rotates x[..., 0] against x[..., hd/2]
    one = np.zeros((1, 1, 1, 4), np.float32)
    one[..., 0] = 1.0
    out = L.apply_rope(torch.from_numpy(one), torch.ones((1, 1), dtype=torch.int64), 1.0)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), [np.cos(1), 0, np.sin(1), 0], atol=1e-6)


@pytest.mark.parametrize("sq,skv,q_offset,kv_len,window,causal,chunk", [
    (40, 40, 0, None, None, True, 16),       # chunked branch, padded last chunk
    (40, 40, 0, None, 8, True, 16),          # sliding window
    (3, 24, 10, 13, None, True, 32),         # decode-like: offset and kv_len
    (1, 24, 0, 5, None, False, 32),          # non-causal ring read
    (33, 48, 0, 33, 16, True, 8),            # every mask term, many chunks
], ids=["chunked", "window", "kv_len", "noncausal", "all"])
def test_flash_attention_equals_reference(sq, skv, q_offset, kv_len, window, causal, chunk):
    rng = np.random.default_rng(11)
    H, KV, hd = 6, 2, 8                      # GQA: 3 query heads per kv head
    q = rng.standard_normal((2, sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, skv, KV, hd)).astype(np.float32)
    kw = dict(q_offset=q_offset, kv_len=kv_len, chunk=chunk, window=window, causal=causal)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    close(got, RL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("act", ["silu", "sq_relu", "gelu"])
def test_mlp_activations_equal_reference(act):
    cfg = dataclasses.replace(smoke_config("smollm-135m"), act=act)
    rcfg = dataclasses.replace(ref_smoke_config("smollm-135m"), act=act)
    # w_up scaled so the hidden units spread over [-6, 6], w_down the
    # identity on the first d_model units: the output is the activation
    # itself, where the tanh gelu and the exact one differ by up to 5e-4
    p = RL.init_mlp(jax.random.key(3), rcfg, jnp.float32)
    p["w_up"] = p["w_up"] * 12.5
    p["w_down"] = jnp.eye(cfg.d_ff, cfg.d_model, dtype=jnp.float32)
    x = np.random.default_rng(12).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = L.mlp(tp, torch.from_numpy(x), cfg, MeshCtx())
    want = np.asarray(RL.mlp(p, jnp.asarray(x), rcfg, RefMeshCtx()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if act == "gelu":                        # the tanh form, not the exact one
        exact = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_up"]) @ tp["w_down"]
        assert float((exact - got).abs().max()) > 1e-4


def _moe_case(impl, skew):
    """A routing case for ``impl`` with the router skewed towards expert 0
    by ``skew``, so the capacity case drops slots."""
    rcfg = dataclasses.replace(ref_smoke_config("qwen3-moe-30b-a3b"))
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, impl=impl))
    cfg = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"), moe=rcfg.moe)
    p = RMOE.init_moe(jax.random.key(4), rcfg, jnp.float32)
    router = np.asarray(p["router"]).copy()
    router[:, 0] += skew
    p["router"] = jnp.asarray(router)
    x = np.random.default_rng(13).standard_normal((64, cfg.d_model)).astype(np.float32) + 0.5
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return cfg, rcfg, p, tp, x


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_equals_reference(impl):
    cfg, rcfg, p, tp, x = _moe_case(impl, skew=0.1)
    se, st, sw, aux = MOE._route(torch.from_numpy(x), tp["router"], cfg.moe)
    rse, rst, rsw, raux = RMOE._route(jnp.asarray(x), p["router"], rcfg.moe)
    assert np.array_equal(se.numpy(), np.asarray(rse))      # the same experts
    assert np.array_equal(st.numpy(), np.asarray(rst))      # in the same order
    close(sw, rsw)
    close(aux, raux)
    T = x.shape[0]
    C = max(8, int(-(-T * cfg.moe.top_k * cfg.moe.capacity_factor // cfg.moe.n_experts)))
    if impl == "capacity":                   # the case drops slots past C
        assert int(torch.bincount(se).max()) > C
    fn, rfn = ((MOE._moe_local_capacity, RMOE._moe_local_capacity) if impl == "capacity"
               else (MOE._moe_local, RMOE._moe_local))
    out, aux = fn(torch.from_numpy(x), tp["router"], tp["w_up"], tp["w_gate"],
                  tp["w_down"], cfg)
    rout, raux = rfn(jnp.asarray(x), p["router"], p["w_up"], p["w_gate"], p["w_down"], rcfg)
    close(out, rout)
    close(aux, raux)


def test_moe_capacity_drops_only_slots_past_c():
    cfg, _, _, tp, x = _moe_case("capacity", skew=0.1)
    out, _ = MOE._moe_local_capacity(torch.from_numpy(x), tp["router"], tp["w_up"],
                                     tp["w_gate"], tp["w_down"], cfg)
    dropless, _ = MOE._moe_local(torch.from_numpy(x), tp["router"], tp["w_up"],
                                 tp["w_gate"], tp["w_down"], cfg)
    se, st, _, _ = MOE._route(torch.from_numpy(x), tp["router"], cfg.moe)
    C = max(8, int(-(-64 * cfg.moe.top_k * cfg.moe.capacity_factor // cfg.moe.n_experts)))
    offs = torch.cumsum(torch.bincount(se, minlength=4), 0) - torch.bincount(se, minlength=4)
    dropped = set(st[torch.arange(se.numel()) - offs[se] >= C].tolist())
    kept = [t for t in range(64) if t not in dropped]
    assert dropped and kept
    np.testing.assert_allclose(out[kept].numpy(), dropless[kept].numpy(), atol=1e-6)
    assert not np.allclose(out[sorted(dropped)].numpy(), dropless[sorted(dropped)].numpy())


def test_ssd_chunked_equals_recurrence_and_reference():
    rng = np.random.default_rng(14)
    Bb, Sq, H, P, N, chunk = 2, 24, 3, 4, 5, 8
    xh = rng.standard_normal((Bb, Sq, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bb, Sq, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((Bb, Sq, N)).astype(np.float32)
    Cm = rng.standard_normal((Bb, Sq, N)).astype(np.float32)
    y, hT = SSM._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), chunk)
    ry, rhT = RSSM._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk)
    close(y, ry)
    close(hT, rhT)
    # step by step: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t
    h = np.zeros((Bb, H, P, N))
    want = np.zeros((Bb, Sq, H, P))
    for t in range(Sq):
        h = (np.exp(dt[:, t] * A)[:, :, None, None] * h
             + np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t]))
        want[:, t] = np.einsum("bhpn,bn->bhp", h, Cm[:, t])
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), h, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        SSM._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), 7)


def test_rglru_scan_equals_loop_and_reference():
    rng = np.random.default_rng(15)
    a = rng.uniform(0.5, 1.0, (2, 37, 6)).astype(np.float32)
    gx = rng.standard_normal((2, 37, 6)).astype(np.float32)
    cfg = smoke_config("recurrentgemma-9b")
    h = RG._seq_scan(torch.from_numpy(a), torch.from_numpy(gx), cfg, MeshCtx())
    rh = RRG._seq_scan(jnp.asarray(a), jnp.asarray(gx), ref_smoke_config("recurrentgemma-9b"),
                       RefMeshCtx())
    close(h, rh)
    want, state = np.zeros_like(gx), np.zeros((2, 6), np.float32)
    for t in range(37):
        state = a[:, t] * state + gx[:, t]
        want[:, t] = state
    np.testing.assert_allclose(h.numpy(), want, atol=1e-5, rtol=1e-5)


def test_hybrid_ring_past_the_window():
    """A prompt longer than the 32-position window fills the ring at slot
    (position mod 32); decoding 40 more steps wraps it again."""
    rmodel, params, model = reference_pair("recurrentgemma-9b", seed=7)
    cfg = model.cfg
    assert cfg.hybrid.window == 32
    rng = np.random.default_rng(16)
    rb, tb = inputs(cfg, rng, 45)
    rlast, rcache = jax.jit(lambda p, b: rmodel.prefill(p, dict(b, max_len=96)))(params, rb)
    last, cache = model.prefill(dict(tb, max_len=96))
    assert cache["g_k"].shape[3] == 32
    close(last, rlast)
    cache_close(cache, rcache)
    rdecode = jax.jit(rmodel.decode_step)
    for _ in range(40):
        rb, tb = inputs(cfg, rng, 1)
        rlast, rcache = rdecode(params, rcache, rb)
        last, cache = model.decode_step(cache, tb)
        close(last, rlast)
    cache_close(cache, rcache)
