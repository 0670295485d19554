"""Core transformer layers: RMSNorm, RoPE, GQA attention over q-chunks
(softmax of each chunk against the whole K/V), MLPs.  Every layer is a
plain function of a parameter dict and tensors, as in the reference."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MeshCtx, truncated_normal_init


# ------------------------------------------------------------- norms

def rms_norm(x, w, eps: float):
    """Normalised in float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def init_rms_norm(shape, dtype, device):
    """``shape``: the width, or a tuple with the stacked layer axes first."""
    return {"w": torch.ones(shape, dtype=dtype, device=device)}


# -------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)     # one host-to-device copy, not one a call
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S).  Rotates split halves
    (x1 = x[..., :hd/2], x2 = x[..., hd/2:]), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = _freqs_on(hd, float(theta), x.device)
    ang = positions[..., :, None].float() * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------- attention

def _attn_block(qg, k, v, qpos, *, kv_len, window, causal, Skv_valid):
    """One q-block of attention against full K/V.

    qg: (B, cq, KV, G, hd) f32 pre-scaled; k/v: (B, Skv, KV, hd).  The
    mask stays (cq, Skv) and broadcasts over batch and heads."""
    Skv = k.shape[1]
    kpos = torch.arange(Skv, device=qg.device)
    s = torch.einsum("bqgnd,bkgd->bqgnk", qg, k.float())
    mask = (kpos < Skv_valid)[None, :]
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    mask = mask[None, :, None, None, :]
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bqgnk,bkgd->bqgnd", p, v.float())
    return out / torch.clamp(l, min=1e-20)


def flash_attention(q, k, v, *, q_offset, kv_len=None, chunk: int = 512,
                    window: int | None = None, causal: bool = True):
    """Attention in q-chunks of ``chunk`` rows, each against all of K/V.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    q_offset: absolute position of q[0] (prefill: 0; decode: cache len).
    kv_len: valid kv length (decode) — positions >= kv_len masked.
    window: sliding-window size (local attention) or None.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, group, hd).float() * scale

    if Sq <= chunk:                       # decode / short prefill: one block
        qpos = q_offset + torch.arange(Sq, device=q.device)
        out = _attn_block(qg, k, v, qpos, kv_len=kv_len, window=window,
                          causal=causal, Skv_valid=k.shape[1])
        return out.reshape(B, Sq, H, hd).to(q.dtype)

    nq = (Sq + chunk - 1) // chunk
    pad = nq * chunk - Sq
    if pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
    outs = []
    for i in range(nq):
        qpos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
        outs.append(_attn_block(qg[:, i * chunk:(i + 1) * chunk], k, v, qpos,
                                kv_len=kv_len, window=window, causal=causal,
                                Skv_valid=k.shape[1]))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].reshape(B, Sq, H, hd).to(q.dtype)


def init_attention(generator, cfg: ModelConfig, dtype, lead=()):
    """Parameters of ``attention``; ``lead`` prefixes every shape (the
    stacked layer axes)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 0.02
    tn = functools.partial(truncated_normal_init, generator, dtype=dtype)
    p = {
        "wq": tn(lead + (d, H, hd), scale=s),
        "wk": tn(lead + (d, KV, hd), scale=s),
        "wv": tn(lead + (d, KV, hd), scale=s),
        "wo": tn(lead + (H, hd, d), scale=s / np.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(lead + (hd,), dtype, generator.device)
        p["k_norm"] = init_rms_norm(lead + (hd,), dtype, generator.device)
    return p


def project_heads(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).reshape(*x.shape[:-1], H, hd)


def merge_heads(x, w):
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, d = w.shape
    return x.reshape(*x.shape[:-2], H * hd) @ w.reshape(H * hd, d)


def write_slice(buf, new, start):
    """buf[:, start:start+S] = new in place, with the start clamped into
    [0, Smax - S] as ``jax.lax.dynamic_update_slice`` clamps it."""
    S = new.shape[1]
    start = min(max(int(start), 0), buf.shape[1] - S)
    buf[:, start:start + S] = new.to(buf.dtype)
    return buf


def attention(p, x, cfg: ModelConfig, mctx: MeshCtx, *, positions,
              window: int | None = None, cache=None, cache_len=None):
    """x: (B, S, D).  cache: optional dict(k, v) of (B, Smax, KV, hd) —
    when given, the new k/v are written into it in place at cache_len and
    attention runs over the whole cache.  Returns (out, cache)."""
    cd = cfg.cdtype
    xq = project_heads(x, p["wq"].to(cd))
    xk = project_heads(x, p["wk"].to(cd))
    xv = project_heads(x, p["wv"].to(cd))
    if cfg.qk_norm:
        xq = rms_norm(xq, p["q_norm"]["w"], cfg.norm_eps)
        xk = rms_norm(xk, p["k_norm"]["w"], cfg.norm_eps)
    xq = apply_rope(xq, positions, cfg.rope_theta)
    xk = apply_rope(xk, positions, cfg.rope_theta)
    xq = mctx.constrain(xq, mctx.dp, None, mctx.tp, None)

    if cache is not None:
        k_all = write_slice(cache["k"], xk, cache_len)
        v_all = write_slice(cache["v"], xv, cache_len)
        out = flash_attention(xq, k_all.to(cd), v_all.to(cd),
                              q_offset=cache_len, kv_len=cache_len + x.shape[1],
                              chunk=cfg.attn_chunk, window=window)
    else:
        out = flash_attention(xq, xk, xv, q_offset=0, chunk=cfg.attn_chunk,
                              window=window)
    res = merge_heads(out, p["wo"].to(cd))
    return mctx.constrain(res, mctx.dp, None, None), cache


# ------------------------------------------------------------- MLPs

def init_mlp(generator, cfg: ModelConfig, dtype, d_ff: int | None = None, lead=()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = 0.02
    tn = functools.partial(truncated_normal_init, generator, dtype=dtype)
    p = {"w_up": tn(lead + (d, f), scale=s),
         "w_down": tn(lead + (f, d), scale=s / np.sqrt(2 * cfg.n_layers))}
    if cfg.act == "silu":
        p["w_gate"] = tn(lead + (d, f), scale=s)
    return p


def mlp(p, x, cfg: ModelConfig, mctx: MeshCtx):
    cd = cfg.cdtype
    h = x @ p["w_up"].to(cd)
    h = mctx.constrain(h, mctx.dp, None, mctx.tp)
    if cfg.act == "silu":
        g = x @ p["w_gate"].to(cd)
        h = F.silu(g) * h
    elif cfg.act == "sq_relu":                    # nemotron-4 squared ReLU
        h = torch.square(F.relu(h))
    elif cfg.act == "gelu":                       # jax.nn.gelu's default form
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.act)
    out = h @ p["w_down"].to(cd)
    return mctx.constrain(out, mctx.dp, None, None)
