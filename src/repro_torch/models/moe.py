"""Mixture-of-Experts FFN: top-k routing with a stable sort of the
routed slots by expert, then either the fixed-capacity grouped product
(``_moe_local_capacity``, the default ``impl``: slots past an expert's
capacity C are dropped) or the dropless grouped product over contiguous
expert groups (``_moe_local``).

Parallelism (``moe_ffn`` on a mesh, the reference's two ``shard_map``
branches, run shard by shard as ``repro_torch.mesh`` sets out): tokens
split over dp; the capacity form is expert-parallel (experts over tp,
the D / F dims all-gathered over fsdp, each tp shard dispatching only
its E/tp experts, the outputs summed over tp); the dropless form is
FSDP (the expert dim all-gathered over fsdp, F split over tp, the
tp-partial outputs summed).  The aux loss is averaged over dp.

On ``meta`` tensors (a dry run, ``runtime.op_cost``: shapes, no values)
routing has no counts to take, so it assumes balanced routing: the
dropless form gives each expert T*top_k/E of the T*top_k routed rows
(the first T*top_k mod E experts one more), which is the reference's
``ragged_dot`` row count under balanced routing; the capacity form's
shapes do not depend on the counts (C = max(8, ceil(T*top_k*cf/E)) with
T a dp shard's tokens).  On a mesh every shard's work then has the same
shapes, so the meta branch runs shard 0's once, counted for every shard
(``op_cost.repeated_call``), and records the collectives each shard
makes.  CPU and CUDA tensors are routed by their values as before.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.mesh import all_gather, axis_index, axis_size, pmean, psum
from repro_torch.models.common import ModelConfig, MeshCtx, truncated_normal_init
from repro_torch.runtime import op_cost


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


def _group_sizes(se, n_experts: int) -> torch.Tensor:
    """Routed slots per expert: counted from ``se`` on a real device,
    balanced on ``meta`` (see the module docstring)."""
    if se.device.type == "meta":
        q, r = divmod(se.shape[0], n_experts)
        return torch.tensor([q + (e < r) for e in range(n_experts)])
    return torch.bincount(se, minlength=n_experts)


def _moe_local(x2d, router, w_up, w_gate, w_down, cfg: ModelConfig):
    """Dropless expert compute with full expert weights: each expert's
    contiguous group of sorted slots through its own products. x2d: (T, D)."""
    m = cfg.moe
    cd = cfg.cdtype
    se, st, sw, aux = _route(x2d, router, m)
    xs = x2d[st].to(cd)                                     # (T*k, D)
    sizes = _group_sizes(se, m.n_experts).tolist()
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


def _moe_local_capacity(x2d, router, w_up, w_gate, w_down, cfg: ModelConfig,
                        e_start: int = 0, e_local: int | None = None):
    """Fixed-capacity grouped product (GShard): every expert takes at most
    C slots, in the stable sort's order; the rest go to the drop column C,
    which is cut off, and add nothing.

    Expert-parallel form: when (e_start, e_local) are given, this shard
    dispatches only experts [e_start, e_start+e_local), positions still
    counted over all experts, and the weights hold those experts only."""
    m = cfg.moe
    cd = cfg.cdtype
    T, D = x2d.shape
    E = m.n_experts
    El = e_local or E
    C = max(8, int(-(-T * m.top_k * m.capacity_factor // E)))
    se, st, sw, aux = _route(x2d, router, m)
    # position of each routed slot within its (global) expert
    gs = _group_sizes(se, E).to(se.device)
    offs = torch.cumsum(gs, dim=0) - gs
    pos = torch.arange(se.shape[0], device=x2d.device) - offs[se]
    sel = se - e_start                                      # local expert id
    keep = (pos < C) & (sel >= 0) & (sel < El)
    e_c = torch.clamp(sel, 0, El - 1)
    pos_c = torch.where(keep, pos, C)                       # C = drop slot
    xe = torch.zeros((El, C + 1, D), dtype=cd, device=x2d.device)
    xe[e_c, pos_c] = x2d[st].to(cd)
    xe = xe[:, :C]                                          # (El, C, D)
    up = torch.bmm(xe, w_up.to(cd))
    gate = torch.bmm(xe, w_gate.to(cd))
    h = F.silu(gate) * up
    y = torch.bmm(h, w_down.to(cd))                         # (El, C, D)
    gathered = y[e_c, torch.clamp(pos, max=C - 1)]          # (T*k, D)
    gathered = gathered * (sw * keep)[:, None].to(cd)
    out = torch.zeros_like(x2d).index_add_(0, st, gathered.to(x2d.dtype))
    return out, aux


def moe_ffn(p, x, cfg: ModelConfig, mctx: MeshCtx):
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    local_fn = (_moe_local_capacity if cfg.moe.impl == "capacity"
                else _moe_local)
    if mctx.mesh is None:
        out, aux = local_fn(x2d, p["router"], p["w_up"], p["w_gate"],
                            p["w_down"], cfg)
        return out.reshape(B, S, D), aux

    if x.device.type == "meta":
        out, aux = _moe_ffn_meta(p, x2d, cfg, mctx, local_fn)
        return out.reshape(B, S, D), aux

    mesh, fsdp, tp = mctx.mesh, mctx.fsdp, mctx.tp
    xl = mctx.named(mctx.dp, None).blocks(x2d)
    router = mctx.named(None, None).blocks(p["router"])

    if cfg.moe.impl == "capacity":
        # EXPERT-PARALLEL: experts sharded over tp, FSDP on the D/F dims.
        # Each tp shard dispatches only its E/tp experts; the combine is
        # the tp psum.
        e_local = cfg.moe.n_experts // mesh.shape[tp]
        w_up = all_gather(mctx.named(tp, fsdp, None).blocks(p["w_up"]), mesh, fsdp, 1)
        w_gate = all_gather(mctx.named(tp, fsdp, None).blocks(p["w_gate"]), mesh, fsdp, 1)
        w_down = all_gather(mctx.named(tp, None, fsdp).blocks(p["w_down"]), mesh, fsdp, 2)
        res = [_moe_local_capacity(xl[i], router[i], w_up[i], w_gate[i], w_down[i], cfg,
                                   axis_index(mesh, tp, i) * e_local, e_local)
               for i in range(len(mesh.devices))]
    else:
        # gather FSDP-sharded expert dim (weights arrive (E/fsdp, D, F/tp))
        w_up = all_gather(mctx.named(fsdp, None, tp).blocks(p["w_up"]), mesh, fsdp, 0)
        w_gate = all_gather(mctx.named(fsdp, None, tp).blocks(p["w_gate"]), mesh, fsdp, 0)
        w_down = all_gather(mctx.named(fsdp, tp, None).blocks(p["w_down"]), mesh, fsdp, 0)
        res = [local_fn(xl[i], router[i], w_up[i], w_gate[i], w_down[i], cfg)
               for i in range(len(mesh.devices))]
    out = psum([o for o, _ in res], mesh, tp)      # combine expert / F shards
    aux = pmean([a for _, a in res], mesh, mctx.dp)
    out = mctx.named(mctx.dp, None).assemble(out, x.device)
    return out.reshape(B, S, D), aux[0].to(x.device)


def _moe_ffn_meta(p, x2d, cfg: ModelConfig, mctx: MeshCtx, local_fn):
    """``moe_ffn``'s mesh branch on ``meta``: shard 0's blocks (its
    tokens, its experts gathered over fsdp) through its local function,
    counted once per device; one all-gather per weight over fsdp, the
    output's psum over tp and the aux loss's pmean over dp recorded as
    each device makes them."""
    mesh, fsdp, tp = mctx.mesh, mctx.fsdp, mctx.tp

    def shard0(x, *spec):
        return x[mctx.named(*spec).index(0, x.shape)]
    xl = shard0(x2d, mctx.dp, None)
    if cfg.moe.impl == "capacity":
        e_local = cfg.moe.n_experts // mesh.shape[tp]
        ws = [shard0(p[w], tp, None, None) for w in ("w_up", "w_gate", "w_down")]
        fn = lambda *a: _moe_local_capacity(*a, cfg, 0, e_local)
    else:
        ws = [shard0(p["w_up"], None, None, tp), shard0(p["w_gate"], None, None, tp),
              shard0(p["w_down"], None, tp, None)]
        fn = lambda *a: local_fn(*a, cfg)
    for w in ws:
        op_cost.record_collective("all-gather", op_cost.nbytes(w), axis_size(mesh, fsdp))
    out, aux = op_cost.repeated_call(len(mesh.devices), fn, xl, p["router"], *ws)
    op_cost.record_collective("all-reduce", op_cost.nbytes(out), axis_size(mesh, tp))
    op_cost.record_collective("all-reduce", op_cost.nbytes(aux), axis_size(mesh, mctx.dp))
    return out.repeat(x2d.shape[0] // xl.shape[0], 1), aux
