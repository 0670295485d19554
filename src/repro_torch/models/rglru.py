"""RG-LRU recurrent block (RecurrentGemma/Griffin hybrid).

Sequence mode runs the input-gated linear recurrence
h_t = a_t * h_{t-1} + b_t as a scan over the sequence (a Hillis-Steele
doubling scan with ``_combine``); decode mode is the single-step update.
The hybrid block pattern (rec, rec, attn) lives in model.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MeshCtx, truncated_normal_init
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # paper's fixed scalar on the recurrence gate


def init_rglru(generator, cfg: ModelConfig, dtype, lead=()):
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    s = 0.02
    tn = functools.partial(truncated_normal_init, generator, dtype=dtype)
    dev = generator.device
    # Lambda init so a = sigmoid(lam)^(c*r) starts near 0.9..0.999
    lam = torch.empty(lead + (w,), dtype=torch.float32, device=dev)
    lam.uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(lam ** (1.0 / _C) / (1 - lam ** (1.0 / _C)))
    return {
        "in_x": tn(lead + (d, w), scale=s),
        "in_gate": tn(lead + (d, w), scale=s),
        "conv_w": tn(lead + (cfg.hybrid.conv_k, w), scale=s),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "w_a": tn(lead + (w, w), scale=s),
        "w_i": tn(lead + (w, w), scale=s),
        "lam": lam,
        "out_proj": tn(lead + (w, d), scale=s / np.sqrt(2 * cfg.n_layers)),
    }


def _gates(p, xb, cfg):
    # the W x W gate products accumulate in xb's dtype (bf16 at full
    # width), as the reference asks with preferred_element_type
    r = torch.sigmoid((xb @ p["w_a"].to(xb.dtype)).float())
    i = torch.sigmoid((xb @ p["w_i"].to(xb.dtype)).float())
    log_a = -_C * r * F.softplus(p["lam"])               # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * xb.float())
    return a, gated_x


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _seq_scan(a, gx, cfg: ModelConfig, mctx: MeshCtx):
    """h_t = a_t h_{t-1} + gx_t over the sequence axis (dim 1), on one
    device: log2(S) doubling steps, each composing every position with
    the one 2^j before it (the identity (1, 0) before the start)."""
    S = a.shape[1]
    step = 1
    while step < S:
        prev_a = F.pad(a[:, :-step], (0, 0, step, 0), value=1.0)
        prev_b = F.pad(gx[:, :-step], (0, 0, step, 0), value=0.0)
        a, gx = _combine((prev_a, prev_b), (a, gx))
        step *= 2
    return gx


def rglru_block(p, x, cfg: ModelConfig, mctx: MeshCtx, *, state=None, conv_buf=None):
    """x: (B, S, D) -> (out, new_state, new_conv_buf)."""
    cd = cfg.cdtype
    k = cfg.hybrid.conv_k
    xb = x @ p["in_x"].to(cd)
    gate = x @ p["in_gate"].to(cd)
    if state is None:
        xb = _causal_conv(xb, p["conv_w"].to(cd), p["conv_b"].to(cd), k)
        new_conv_buf = None   # primed separately via rglru_prime_conv_buf
    else:
        buf = torch.cat([conv_buf, xb], dim=1)
        xb = (torch.einsum("bkc,kc->bc", buf, p["conv_w"].to(cd))
              + p["conv_b"].to(cd))[:, None, :]
        new_conv_buf = buf[:, 1:, :]
    a, gx = _gates(p, xb, cfg)

    if state is None:
        h = _seq_scan(a, gx, cfg, mctx)
        new_state = h[:, -1]
    else:
        h = (state * a[:, 0] + gx[:, 0])[:, None]
        new_state = h[:, 0]

    out = h.to(cd) * F.gelu(gate, approximate="tanh")
    out = out @ p["out_proj"].to(cd)
    return out, new_state, new_conv_buf


def rglru_prime_conv_buf(p, x, cfg: ModelConfig):
    """After a prefill, the decode conv buffer = last (k-1) raw xb inputs."""
    xb = x @ p["in_x"].to(cfg.cdtype)
    return xb[:, -(cfg.hybrid.conv_k - 1):, :]
