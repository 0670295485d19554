"""Model assembly: forward / loss / prefill / decode for every
architecture family (dense / moe / ssm / hybrid).

``Model`` is an ``nn.Module`` that holds the reference's parameter tree
as it is: each block leaf is stacked over the layers (dense, moe, ssm),
over the groups of the hybrid pattern and over its tail, so its
``state_dict`` keys are the reference tree's paths joined with dots and
``convert.params_from_reference`` loads the reference's own weights.
The layer loops run eagerly, one layer's slice of the stack at a time.
``prefill`` and ``decode_step`` write the KV / state cache in place.

``forward`` and ``loss_fn`` are differentiable end to end; autograd's
gradients reach the stacked parameters through the per-layer views.
``remat_policy`` rematerialises each unit of the reference's scans (one
block for dense, moe and ssm; one group of the hybrid pattern; one tail
sublayer) with ``torch.utils.checkpoint``: "full" keeps only the unit's
inputs (``checkpoint_policies.nothing_saveable``), "dots" also keeps the
outputs of its matrix products (``checkpoint_policies.checkpoint_dots``).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.convert import resolve_device
from repro_torch.models.common import (ModelConfig, MeshCtx, MetaGenerator,
                                       truncated_normal_init)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import rglru as RG


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // 4096) * 4096


# =====================================================================
# block definitions (one per family); ``lead`` is the stacked axes
# =====================================================================

def _init_dense_block(g, cfg, dtype, lead):
    return {"ln1": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
            "attn": L.init_attention(g, cfg, dtype, lead),
            "ln2": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
            "mlp": L.init_mlp(g, cfg, dtype, lead=lead)}


def _dense_block(p, x, cfg, mctx, positions, cache=None, cache_len=None,
                 window=None):
    h, new_cache = L.attention(p["attn"], L.rms_norm(x, p["ln1"]["w"], cfg.norm_eps),
                               cfg, mctx, positions=positions, cache=cache,
                               cache_len=cache_len, window=window)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]["w"], cfg.norm_eps), cfg, mctx)
    return x, new_cache


def _init_moe_block(g, cfg, dtype, lead):
    return {"ln1": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
            "attn": L.init_attention(g, cfg, dtype, lead),
            "ln2": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
            "moe": MOE.init_moe(g, cfg, dtype, lead)}


def _moe_block(p, x, cfg, mctx, positions, cache=None, cache_len=None):
    h, new_cache = L.attention(p["attn"], L.rms_norm(x, p["ln1"]["w"], cfg.norm_eps),
                               cfg, mctx, positions=positions, cache=cache,
                               cache_len=cache_len)
    x = x + h
    h, aux = MOE.moe_ffn(p["moe"], L.rms_norm(x, p["ln2"]["w"], cfg.norm_eps), cfg, mctx)
    return x + h, aux, new_cache


def _init_ssm_block(g, cfg, dtype, lead):
    return {"ln": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
            "ssm": SSM.init_ssm(g, cfg, dtype, lead)}


def _ssm_block(p, x, cfg, mctx, state=None, conv_buf=None):
    h, new_state, new_buf = SSM.ssm_block(
        p["ssm"], L.rms_norm(x, p["ln"]["w"], cfg.norm_eps), cfg, mctx,
        state=state, conv_buf=conv_buf)
    return x + h, new_state, new_buf


def _init_hybrid_sublayer(g, cfg, dtype, kind: str, lead):
    p = {"ln1": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
         "ln2": L.init_rms_norm(lead + (cfg.d_model,), dtype, g.device),
         "mlp": L.init_mlp(g, cfg, dtype, lead=lead)}
    if kind == "rec":
        p["rec"] = RG.init_rglru(g, cfg, dtype, lead)
    else:
        p["attn"] = L.init_attention(g, cfg, dtype, lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's parameter tree, drawn from ``generator`` on its
    device."""
    dtype = cfg.pdtype
    params: dict[str, Any] = {}
    if not cfg.embeds_input:
        params["embed"] = truncated_normal_init(
            generator, (padded_vocab(cfg), cfg.d_model), dtype, 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            generator, (cfg.d_model, padded_vocab(cfg)), dtype, 0.02)
    params["ln_f"] = L.init_rms_norm(cfg.d_model, dtype, generator.device)
    lead = (cfg.n_layers,)
    if cfg.family == "dense":
        params["blocks"] = _init_dense_block(generator, cfg, dtype, lead)
    elif cfg.family == "moe":
        params["blocks"] = _init_moe_block(generator, cfg, dtype, lead)
    elif cfg.family == "ssm":
        params["blocks"] = _init_ssm_block(generator, cfg, dtype, lead)
    elif cfg.family == "hybrid":
        hy = cfg.hybrid
        params["groups"] = {
            f"sub{i}_{kind}": _init_hybrid_sublayer(generator, cfg, dtype, kind,
                                                    (hy.n_groups,))
            for i, kind in enumerate(hy.pattern)}
        params["tail"] = _init_hybrid_sublayer(generator, cfg, dtype, "rec",
                                               (len(hy.tail),))
    else:
        raise ValueError(cfg.family)
    return params


REMAT_POLICIES = ("none", "full", "dots")
# what a matrix product dispatches to here: ``@`` and ``einsum`` reach
# these through ``matmul``'s decomposition
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class ParamTree(nn.Module):
    """A nested dict of tensors as modules and parameters: a dict becomes
    a child module, a tensor a parameter, so ``state_dict`` keys are the
    tree's paths joined with dots."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


# =====================================================================
# the model object
# =====================================================================

class Model(ParamTree):
    """One architecture's parameters and its forward, loss, prefill and
    decode.  Build it with ``build_model``."""

    def __init__(self, cfg: ModelConfig, mctx: MeshCtx | None = None,
                 remat_policy: str = "none", *, device=None,
                 generator: torch.Generator | None = None):
        mctx = mctx or MeshCtx()
        if device is None and mctx.mesh is not None:
            device = mctx.mesh.devices[0]
        device = resolve_device(device)
        if device.type == "meta":
            generator = MetaGenerator()
        elif generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(init_params(cfg, generator))
        self.to(device)
        self.cfg = cfg
        self.mctx = mctx
        self.remat_policy = remat_policy

    @property
    def remat_policy(self) -> str:
        return self._remat_policy

    @remat_policy.setter
    def remat_policy(self, policy: str) -> None:
        if policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={policy!r}: one of {REMAT_POLICIES}")
        self._remat_policy = policy

    # ---------------------------------------------------------- remat
    def _maybe_remat(self, fn):
        """``fn`` as one rematerialised unit under the model's policy."""
        if self.remat_policy == "none":
            return fn
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False, **kw)

    @property
    def device(self) -> torch.device:
        return self.ln_f.w.device

    # ------------------------------------------------------ embeddings
    def _embed_in(self, params, batch):
        cfg = self.cfg
        if cfg.embeds_input:
            x = batch["embeds"].to(cfg.cdtype)
        else:
            x = params["embed"][batch["tokens"].long()].to(cfg.cdtype)
        return self.mctx.constrain(x, self.mctx.dp, None, None)

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["ln_f"]["w"], cfg.norm_eps)
        head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        logits = (x @ head.to(cfg.cdtype)).float()
        return self.mctx.constrain(logits, self.mctx.dp, None, self.mctx.tp)

    def _positions(self, B, S):
        return torch.arange(S, device=self.device).expand(B, S)

    # --------------------------------------------------- train forward
    def forward(self, batch):
        """-> (logits (B,S,Vpad) f32, aux dict)."""
        cfg, mctx = self.cfg, self.mctx
        params = self.tree()
        x = self._embed_in(params, batch)
        B, S, _ = x.shape
        positions = self._positions(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

        # each unit slices its layer inside, so a rematerialised unit
        # recomputes the views from the stacked parameters
        if cfg.family == "dense":
            def body(x, i):
                return _dense_block(_layer(params["blocks"], i), x, cfg, mctx, positions)[0]
            body = self._maybe_remat(body)
            for i in range(cfg.n_layers):
                x = body(x, i)
        elif cfg.family == "moe":
            def body(x, aux, i):
                y, a, _ = _moe_block(_layer(params["blocks"], i), x, cfg, mctx, positions)
                return y, aux + a
            body = self._maybe_remat(body)
            for i in range(cfg.n_layers):
                x, aux_total = body(x, aux_total, i)
        elif cfg.family == "ssm":
            def body(x, i):
                return _ssm_block(_layer(params["blocks"], i), x, cfg, mctx)[0]
            body = self._maybe_remat(body)
            for i in range(cfg.n_layers):
                x = body(x, i)
        elif cfg.family == "hybrid":
            hy = cfg.hybrid

            def gbody(x, gi):
                gp = _layer(params["groups"], gi)
                for i, kind in enumerate(hy.pattern):
                    x = self._hybrid_sublayer(gp[f"sub{i}_{kind}"], x, kind, positions)
                return x

            def tbody(x, ti):
                return self._hybrid_sublayer(_layer(params["tail"], ti), x, "rec", positions)
            gbody, tbody = self._maybe_remat(gbody), self._maybe_remat(tbody)
            for gi in range(hy.n_groups):
                x = gbody(x, gi)
            for ti in range(len(hy.tail)):
                x = tbody(x, ti)
        return self._logits(params, x), {"moe_aux": aux_total}

    def _hybrid_sublayer(self, sp, x, kind, positions):
        cfg, mctx = self.cfg, self.mctx
        if kind == "rec":
            h, _, _ = RG.rglru_block(
                sp["rec"], L.rms_norm(x, sp["ln1"]["w"], cfg.norm_eps), cfg, mctx)
        else:
            h, _ = L.attention(
                sp["attn"], L.rms_norm(x, sp["ln1"]["w"], cfg.norm_eps), cfg, mctx,
                positions=positions, window=cfg.hybrid.window)
        x = x + h
        return x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]["w"], cfg.norm_eps), cfg, mctx)

    # --------------------------------------------------------- loss
    def loss_fn(self, batch):
        logits, aux = self.forward(batch)
        labels = batch["labels"].long()
        V = padded_vocab(self.cfg)
        if V != self.cfg.vocab:   # mask padded vocab rows out of softmax
            pad_mask = torch.arange(V, device=logits.device) >= self.cfg.vocab
            logits = torch.where(pad_mask[None, None, :], -1e30, logits)
        lse = torch.logsumexp(logits, dim=-1)
        # a negative label counts from the end, as the reference's gather does
        gold = torch.gather(logits, -1, torch.remainder(labels, V)[..., None])[..., 0]
        mask = (labels >= 0).float()
        nll = (lse - gold) * mask
        loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
        if self.cfg.moe is not None:
            loss = loss + self.cfg.moe.aux_coef * aux["moe_aux"] / self.cfg.n_layers
        return loss, {"nll": loss, **aux}

    # ------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        cache: dict[str, Any] = {"len": 0}
        if cfg.family in ("dense", "moe"):
            cache["k"] = zeros((cfg.n_layers, batch, max_len, KV, hd), dtype)
            cache["v"] = zeros((cfg.n_layers, batch, max_len, KV, hd), dtype)
        elif cfg.family == "ssm":
            d_inner, nheads = SSM._dims(cfg)
            s = cfg.ssm
            conv_ch = d_inner + 2 * s.d_state
            cache["state"] = zeros(
                (cfg.n_layers, batch, nheads, s.headdim, s.d_state), torch.float32)
            cache["conv"] = zeros((cfg.n_layers, batch, s.d_conv - 1, conv_ch), dtype)
        elif cfg.family == "hybrid":
            hy = cfg.hybrid
            w = hy.lru_width or cfg.d_model
            wl = min(max_len, hy.window)
            n_rec_g = sum(1 for k in hy.pattern if k == "rec")
            n_att_g = len(hy.pattern) - n_rec_g
            cache["g_state"] = zeros((hy.n_groups, n_rec_g, batch, w), torch.float32)
            cache["g_conv"] = zeros((hy.n_groups, n_rec_g, batch, hy.conv_k - 1, w), dtype)
            cache["g_k"] = zeros((hy.n_groups, n_att_g, batch, wl, KV, hd), dtype)
            cache["g_v"] = zeros((hy.n_groups, n_att_g, batch, wl, KV, hd), dtype)
            cache["t_state"] = zeros((len(hy.tail), batch, w), torch.float32)
            cache["t_conv"] = zeros((len(hy.tail), batch, hy.conv_k - 1, w), dtype)
        return cache

    @torch.no_grad()
    def prefill(self, batch) -> tuple[torch.Tensor, dict]:
        """Process a full prompt; returns (last-position logits (B, Vpad),
        primed cache).  ``batch["max_len"]`` sizes the cache (default S)."""
        cfg, mctx = self.cfg, self.mctx
        params = self.tree()
        x = self._embed_in(params, batch)
        B, S, _ = x.shape
        positions = self._positions(B, S)
        cache = self.init_cache(B, batch.get("max_len", S), dtype=cfg.cdtype)
        cache["len"] = S

        if cfg.family in ("dense", "moe"):
            for i in range(cfg.n_layers):
                bp = _layer(params["blocks"], i)
                kv = {"k": cache["k"][i], "v": cache["v"][i]}
                if cfg.family == "dense":
                    x, _ = _dense_block(bp, x, cfg, mctx, positions, cache=kv, cache_len=0)
                else:
                    x, _, _ = _moe_block(bp, x, cfg, mctx, positions, cache=kv, cache_len=0)
        elif cfg.family == "ssm":
            sts, bufs = [], []
            for i in range(cfg.n_layers):
                # the conv buffer is the block's pre-conv [x, B, C] stream
                x, st, buf = _ssm_block(_layer(params["blocks"], i), x, cfg, mctx)
                sts.append(st)
                bufs.append(buf)
            cache["state"] = torch.stack(sts)
            cache["conv"] = torch.stack(bufs).to(cfg.cdtype)
        elif cfg.family == "hybrid":
            x = self._hybrid_prefill(params, x, positions, cache)
        logits = self._logits(params, x[:, -1:, :])[:, 0]
        return logits, cache

    def _hybrid_prefill(self, params, x, positions, cache):
        """Runs the hybrid stack over the prompt and fills ``cache``: each
        attention sublayer's ring holds the last ``wl`` positions at slot
        (position mod wl)."""
        cfg, mctx = self.cfg, self.mctx
        hy = cfg.hybrid
        cd = cfg.cdtype
        wl = cache["g_k"].shape[3]
        S = x.shape[1]

        def fill_window(roped_kv):
            if S >= wl:
                return torch.roll(roped_kv[:, -wl:], (S - wl) % wl, dims=1)
            return torch.nn.functional.pad(
                roped_kv, (0, 0, 0, 0, 0, wl - S))

        def rec_sublayer(sp, y):
            xin = L.rms_norm(y, sp["ln1"]["w"], cfg.norm_eps)
            h, st, _ = RG.rglru_block(sp["rec"], xin, cfg, mctx)
            buf = RG.rglru_prime_conv_buf(sp["rec"], xin, cfg).to(cd)
            y = y + h
            y = y + L.mlp(sp["mlp"], L.rms_norm(y, sp["ln2"]["w"], cfg.norm_eps), cfg, mctx)
            return y, st, buf

        for gi in range(hy.n_groups):
            gp = _layer(params["groups"], gi)
            ri = ai = 0
            for i, kind in enumerate(hy.pattern):
                sp = gp[f"sub{i}_{kind}"]
                if kind == "rec":
                    x, st, buf = rec_sublayer(sp, x)
                    cache["g_state"][gi, ri] = st
                    cache["g_conv"][gi, ri] = buf
                    ri += 1
                else:
                    xin = L.rms_norm(x, sp["ln1"]["w"], cfg.norm_eps)
                    xq = L.project_heads(xin, sp["attn"]["wq"].to(cd))
                    xk = L.project_heads(xin, sp["attn"]["wk"].to(cd))
                    xv = L.project_heads(xin, sp["attn"]["wv"].to(cd))
                    xq = L.apply_rope(xq, positions, cfg.rope_theta)
                    xkr = L.apply_rope(xk, positions, cfg.rope_theta)
                    att = L.flash_attention(xq, xkr, xv, q_offset=0,
                                            chunk=cfg.attn_chunk, window=hy.window)
                    h = L.merge_heads(att, sp["attn"]["wo"].to(cd))
                    cache["g_k"][gi, ai] = fill_window(xkr)
                    cache["g_v"][gi, ai] = fill_window(xv)
                    ai += 1
                    x = x + h
                    x = x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]["w"], cfg.norm_eps),
                                  cfg, mctx)
        for ti in range(len(hy.tail)):
            x, st, buf = rec_sublayer(_layer(params["tail"], ti), x)
            cache["t_state"][ti] = st
            cache["t_conv"][ti] = buf
        return x

    @torch.no_grad()
    def decode_step(self, cache, batch) -> tuple[torch.Tensor, dict]:
        """One token for every sequence.  batch: tokens (B,1) or embeds
        (B,1,D).  Writes the cache in place and returns (logits (B, Vpad),
        the cache dict with ``len`` advanced)."""
        cfg, mctx = self.cfg, self.mctx
        params = self.tree()
        x = self._embed_in(params, batch)
        B = x.shape[0]
        clen = cache["len"]
        positions = torch.full((B, 1), clen, dtype=torch.int64, device=x.device)

        if cfg.family in ("dense", "moe"):
            for i in range(cfg.n_layers):
                bp = _layer(params["blocks"], i)
                kv = {"k": cache["k"][i], "v": cache["v"][i]}
                if cfg.family == "dense":
                    x, _ = _dense_block(bp, x, cfg, mctx, positions, cache=kv, cache_len=clen)
                else:
                    x, _, _ = _moe_block(bp, x, cfg, mctx, positions, cache=kv,
                                         cache_len=clen)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x, st, buf = _ssm_block(_layer(params["blocks"], i), x, cfg, mctx,
                                        state=cache["state"][i], conv_buf=cache["conv"][i])
                cache["state"][i] = st
                cache["conv"][i] = buf
        elif cfg.family == "hybrid":
            x = self._hybrid_decode(params, x, positions, cache)

        logits = self._logits(params, x)[:, 0]
        return logits, dict(cache, len=clen + 1)

    def _hybrid_decode(self, params, x, positions, cache):
        cfg, mctx = self.cfg, self.mctx
        hy = cfg.hybrid
        cd = cfg.cdtype
        wl = cache["g_k"].shape[3]
        clen = cache["len"]
        slot = clen % wl

        def rec_sublayer(sp, y, state, conv_buf):
            h, s2, b2 = RG.rglru_block(
                sp["rec"], L.rms_norm(y, sp["ln1"]["w"], cfg.norm_eps),
                cfg, mctx, state=state, conv_buf=conv_buf)
            state.copy_(s2)
            conv_buf.copy_(b2)
            return y + h

        for gi in range(hy.n_groups):
            gp = _layer(params["groups"], gi)
            ri = ai = 0
            for i, kind in enumerate(hy.pattern):
                sp = gp[f"sub{i}_{kind}"]
                if kind == "rec":
                    x = rec_sublayer(sp, x, cache["g_state"][gi, ri], cache["g_conv"][gi, ri])
                    ri += 1
                else:
                    xin = L.rms_norm(x, sp["ln1"]["w"], cfg.norm_eps)
                    xq = L.project_heads(xin, sp["attn"]["wq"].to(cd))
                    xk = L.project_heads(xin, sp["attn"]["wk"].to(cd))
                    xv = L.project_heads(xin, sp["attn"]["wv"].to(cd))
                    xq = L.apply_rope(xq, positions, cfg.rope_theta)
                    xkr = L.apply_rope(xk, positions, cfg.rope_theta)
                    k2 = L.write_slice(cache["g_k"][gi, ai], xkr, slot)
                    v2 = L.write_slice(cache["g_v"][gi, ai], xv, slot)
                    valid = min(clen + 1, wl)
                    att = L.flash_attention(xq, k2.to(cd), v2.to(cd),
                                            q_offset=0, kv_len=valid,
                                            chunk=cfg.attn_chunk, causal=False)
                    x = x + L.merge_heads(att, sp["attn"]["wo"].to(cd))
                    ai += 1
                x = x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]["w"], cfg.norm_eps),
                              cfg, mctx)
        for ti in range(len(hy.tail)):
            sp = _layer(params["tail"], ti)
            x = rec_sublayer(sp, x, cache["t_state"][ti], cache["t_conv"][ti])
            x = x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]["w"], cfg.norm_eps), cfg, mctx)
        return x


def build_model(cfg: ModelConfig, mctx: MeshCtx | None = None, device=None,
                generator: torch.Generator | None = None,
                remat_policy: str = "none") -> Model:
    """A ``Model`` with parameters drawn from ``generator`` (a fresh one
    seeded 0 on ``device`` if none is given) on ``device``: the mesh's
    first device where ``mctx`` has a mesh, else the card, unless the
    caller names another.  On ``device="meta"`` nothing is drawn or
    allocated: the parameters have their shapes and dtypes only."""
    return Model(cfg, mctx, remat_policy, device=device, generator=generator)
