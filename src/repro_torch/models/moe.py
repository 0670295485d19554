"""Mixture-of-Experts FFN on one device: top-k routing with a stable
sort of the routed slots by expert, then either the fixed-capacity
grouped product (``_moe_local_capacity``, the default ``impl``: slots
past an expert's capacity C are dropped) or the dropless grouped
product over contiguous expert groups (``_moe_local``).  The
multi-device branches (expert and FSDP sharding) are not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MeshCtx, truncated_normal_init


def init_moe(generator, cfg: ModelConfig, dtype, lead=()):
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    s = 0.02
    tn = functools.partial(truncated_normal_init, generator)
    return {
        "router": tn(lead + (d, e), torch.float32, s),
        "w_up": tn(lead + (e, d, f), dtype, s),
        "w_gate": tn(lead + (e, d, f), dtype, s),
        "w_down": tn(lead + (e, f, d), dtype, s / np.sqrt(2 * cfg.n_layers)),
    }


def _route(x2d, router, m):
    """-> (experts, tokens, weights) of the T*top_k routed slots sorted
    stably by expert, and the load-balance aux loss."""
    T = x2d.shape[0]
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)          # (T, k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)     # renormalize
    # load-balance aux (switch-style): E * sum(frac_tokens * frac_prob)
    counts = torch.sum(F.one_hot(topi, m.n_experts).float(), dim=(0, 1))
    f_e = counts / (T * m.top_k)
    p_e = torch.mean(probs, dim=0)
    aux = m.n_experts * torch.sum(f_e * p_e)
    flat_e = topi.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(T, device=x2d.device).repeat_interleave(m.top_k)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    return flat_e[order], flat_t[order], flat_w[order], aux


def _moe_local(x2d, router, w_up, w_gate, w_down, cfg: ModelConfig):
    """Dropless expert compute with full expert weights: each expert's
    contiguous group of sorted slots through its own products. x2d: (T, D)."""
    m = cfg.moe
    cd = cfg.cdtype
    se, st, sw, aux = _route(x2d, router, m)
    xs = x2d[st].to(cd)                                     # (T*k, D)
    sizes = torch.bincount(se, minlength=m.n_experts).tolist()
    y = torch.empty((xs.shape[0], w_down.shape[-1]), dtype=cd, device=x2d.device)
    start = 0
    for e, size in enumerate(sizes):
        rows = slice(start, start + size)
        up = xs[rows] @ w_up[e].to(cd)
        gate = xs[rows] @ w_gate[e].to(cd)
        y[rows] = (F.silu(gate) * up) @ w_down[e].to(cd)
        start += size
    y = y * sw[:, None].to(cd)
    out = torch.zeros_like(x2d).index_add_(0, st, y.to(x2d.dtype))
    return out, aux


def _moe_local_capacity(x2d, router, w_up, w_gate, w_down, cfg: ModelConfig):
    """Fixed-capacity grouped product (GShard): every expert takes at most
    C slots, in the stable sort's order; the rest go to the drop column C,
    which is cut off, and add nothing."""
    m = cfg.moe
    cd = cfg.cdtype
    T, D = x2d.shape
    E = m.n_experts
    C = max(8, int(-(-T * m.top_k * m.capacity_factor // E)))
    se, st, sw, aux = _route(x2d, router, m)
    # position of each routed slot within its expert
    gs = torch.bincount(se, minlength=E)
    offs = torch.cumsum(gs, dim=0) - gs
    pos = torch.arange(se.shape[0], device=x2d.device) - offs[se]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                       # C = drop slot
    xe = torch.zeros((E, C + 1, D), dtype=cd, device=x2d.device)
    xe[se, pos_c] = x2d[st].to(cd)
    xe = xe[:, :C]                                          # (E, C, D)
    up = torch.bmm(xe, w_up.to(cd))
    gate = torch.bmm(xe, w_gate.to(cd))
    h = F.silu(gate) * up
    y = torch.bmm(h, w_down.to(cd))                         # (E, C, D)
    gathered = y[se, torch.clamp(pos, max=C - 1)]           # (T*k, D)
    gathered = gathered * (sw * keep)[:, None].to(cd)
    out = torch.zeros_like(x2d).index_add_(0, st, gathered.to(x2d.dtype))
    return out, aux


def moe_ffn(p, x, cfg: ModelConfig, mctx: MeshCtx):
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    local_fn = (_moe_local_capacity if cfg.moe.impl == "capacity"
                else _moe_local)
    out, aux = local_fn(x2d, p["router"], p["w_up"], p["w_gate"],
                        p["w_down"], cfg)
    return out.reshape(B, S, D), aux
