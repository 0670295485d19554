"""Mamba-2 SSD (state-space duality) block — chunked matmul algorithm.

Prefill/forward path: the chunked SSD decomposition (intra-chunk
quadratic term + inter-chunk state recurrence, a loop over chunks).
Decode path: single-step linear recurrence on the (B, H, hd, d_state)
state.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MeshCtx, truncated_normal_init
from repro_torch.models.layers import rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.headdim
    return d_inner, nheads


def init_ssm(generator, cfg: ModelConfig, dtype, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads = _dims(cfg)
    conv_ch = d_inner + 2 * s.d_state       # x, B, C get convolved
    sc = 0.02
    tn = functools.partial(truncated_normal_init, generator, dtype=dtype)
    dev = generator.device
    return {
        "in_proj": tn(lead + (d, 2 * d_inner + 2 * s.d_state + nheads), scale=sc),
        "conv_w": tn(lead + (s.d_conv, conv_ch), scale=sc),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros(lead + (nheads,), dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (nheads,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones(lead + (d_inner,), dtype=dtype, device=dev),
        "out_proj": tn(lead + (d_inner, d), scale=sc / np.sqrt(2 * cfg.n_layers)),
    }


def _causal_conv(x, w, b, k: int):
    """Depthwise causal conv1d as k shifted sums. x: (B, S, C), w: (k, C)."""
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD: xh (B,S,H,P), dt (B,S,H) >=0, A (H,) <0 decay rates,
    Bm/Cm (B,S,N); S must be a whole number of chunks.  Returns
    (y (B,S,H,P), final_state (B,H,P,N))."""
    Bb, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"_ssd_chunked: S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    a = dt * A                                   # (B,S,H) log-decay, <= 0
    xc = xh.reshape(Bb, nc, chunk, H, Pd)
    dtc = dt.reshape(Bb, nc, chunk, H)
    ac = a.reshape(Bb, nc, chunk, H)
    Bc = Bm.reshape(Bb, nc, chunk, N)
    Cc = Cm.reshape(Bb, nc, chunk, N)
    acs = torch.cumsum(ac, dim=2)                # within-chunk cumulative
    # intra-chunk (quadratic, causal):
    # L[t,s] = exp(acs[t] - acs[s]) * (t >= s), score = C_t . B_s * dt_s
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]          # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    # above the diagonal seg is positive and grows with the chunk: exp of
    # it overflows at mamba2-370m's chunk of 256, and the masked product's
    # backward is then 0 * inf = NaN.  exp of -inf there gives the same
    # forward values and a finite gradient (the reference takes exp(seg))
    tri = tri[None, None, :, :, None]
    L = torch.where(tri, torch.exp(torch.where(tri, seg, -torch.inf)), 0.0)
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)             # (B,nc,t,s)
    y_diag = torch.einsum("bcts,bctsh,bcsh,bcshp->bcthp", scores, L, dtc, xc)
    # chunk state: states[c] = sum_s exp(acs[last]-acs[s]) dt_s B_s x_s
    decay_s = torch.exp(acs[:, :, -1:, :] - acs)                 # (B,nc,chunk,H)
    states = torch.einsum("bcsh,bcsh,bcsn,bcshp->bchpn", decay_s, dtc, Bc, xc)
    chunk_decay = torch.exp(acs[:, :, -1, :])                    # (B,nc,H)

    h = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):                          # state entering each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None].float() + states[:, c].float()
    h_prev = torch.stack(h_prev, dim=1)          # (B,nc,H,P,N)
    # inter-chunk contribution: y_off[t] = exp(acs[t]) * C_t . h_prev
    decay_out = torch.exp(acs)                   # (B,nc,chunk,H)
    y_off = torch.einsum("bcth,bctn,bchpn->bcthp", decay_out, Cc, h_prev.to(Cc.dtype))
    y = (y_diag + y_off).reshape(Bb, S, H, Pd)
    return y, h


def ssm_block(p, x, cfg: ModelConfig, mctx: MeshCtx, *, state=None, conv_buf=None):
    """x: (B, S, D).  If state is given (decode), S must be 1 and the
    function returns (y, new_state, new_conv_buf); else (y, final_state,
    last_conv_window) for cache priming."""
    s = cfg.ssm
    d_inner, nheads = _dims(cfg)
    cd = cfg.cdtype
    B, S, _ = x.shape
    proj = x @ p["in_proj"].to(cd)
    z, xr, Bm, Cm, dt = torch.split(
        proj, [d_inner, d_inner, s.d_state, s.d_state, nheads], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    A = -torch.exp(p["A_log"])                   # (H,) negative decay
    dt = F.softplus(dt.float() + p["dt_bias"])

    if state is None:
        conv = _causal_conv(conv_in, p["conv_w"].to(cd), p["conv_b"].to(cd), s.d_conv)
        conv = F.silu(conv)
        xr, Bm, Cm = torch.split(conv, [d_inner, s.d_state, s.d_state], dim=-1)
        xh = xr.reshape(B, S, nheads, s.headdim)
        xh = mctx.constrain(xh, mctx.dp, None, mctx.tp, None)
        # pad S to a chunk multiple; dt=0 on pads => identity state update
        ch = min(s.chunk, S)
        pad = (-S) % ch
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, pad))
        else:
            xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
        y, hT = _ssd_chunked(xh_p.float(), dt_p, A, Bm_p.float(), Cm_p.float(), ch)
        y = y[:, :S]
        y = y + xh.float() * p["D"][None, None, :, None]
        new_conv_buf = conv_in[:, -(s.d_conv - 1):, :]
    else:
        # single-token recurrence
        buf = torch.cat([conv_buf, conv_in], dim=1)          # (B, d_conv, C)
        conv = torch.einsum("bkc,kc->bc", buf, p["conv_w"].to(cd)) + p["conv_b"].to(cd)
        conv = F.silu(conv)[:, None, :]
        xr, Bm, Cm = torch.split(conv, [d_inner, s.d_state, s.d_state], dim=-1)
        xh = xr.reshape(B, 1, nheads, s.headdim).float()
        dtb = dt[:, 0]                                       # (B,H)
        decay = torch.exp(dtb * A)                           # (B,H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtb, Bm[:, 0].float(), xh[:, 0])
        hT = state * decay[:, :, None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hT)[:, None]
        y = y + xh * p["D"][None, None, :, None]
        new_conv_buf = buf[:, 1:, :]

    y = y.reshape(B, S, d_inner).to(cd)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)    # gated norm
    out = y @ p["out_proj"].to(cd)
    return mctx.constrain(out, mctx.dp, None, None), hT, new_conv_buf
