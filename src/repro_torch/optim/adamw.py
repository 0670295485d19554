"""AdamW with optional 8-bit (blockwise-quantized) moments, gradient
clipping, and WSD / cosine / linear schedules: the reference's
optimizer on nests of dicts of tensors.

The update is the reference's own, operation for operation (not
``torch.optim.AdamW``, whose operations come in another order):
``p - lr * (u + wd * p)`` with ``u = (m / b1c) / (sqrt(v / b2c) + eps)``,
the gradients first scaled by ``min(1, clip_norm / (global_norm + 1e-9))``.
The schedule and the bias corrections are float32 tensors, as the
reference computes them.  The state keeps the reference's tree:
``{"step", "m", "v"}``, an int8 moment as ``{"q", "scale"}``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import tree as T

BLOCK = 256  # quantization block (last-dim groups)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"      # float32 | int8
    schedule: str = "cosine"            # cosine | wsd | linear | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1             # WSD: fraction of steps in decay


# --------------------------------------------------------- schedules

def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# The reference runs under jit, and XLA's CPU backend compiles three of
# its float32 patterns otherwise than they read: a division by a constant
# becomes a product with the constant's float32 reciprocal, (a / b) / c
# becomes a / (b * c), and a * b + c one fused multiply-add (rounded
# once).  The port writes them so, so that the two packages' optimizer
# states agree bit for bit.

def _div_const(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a constant c, as XLA computes it."""
    return x * float(np.float32(1.0) / np.float32(c))


def _fma(a, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c in float32, rounded once: the float64 product of two
    float32 values is exact.  ``a`` and ``c`` may be constants (taken at
    float32)."""
    a = a.double() if isinstance(a, torch.Tensor) else float(np.float32(a))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    return (b.double() * a + c).float()


def schedule_fn(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.minimum(_div_const(step, max(c.warmup_steps, 1)), _f32(1.0, dev))
    t = torch.clamp(_div_const(step - _f32(c.warmup_steps, dev),
                               max(c.total_steps - c.warmup_steps, 1)), 0.0, 1.0)
    if c.schedule == "cosine":
        mult = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * t))
    elif c.schedule == "wsd":           # warmup-stable-decay (MiniCPM)
        decay_start = 1.0 - c.decay_frac
        mult = torch.where(t < decay_start, _f32(1.0, dev),
                           _fma(np.float32(1.0) / np.float32(max(c.decay_frac, 1e-6)),
                                -(t - decay_start), 1.0))
    elif c.schedule == "linear":
        mult = 1.0 - t
    else:
        mult = torch.ones((), dtype=torch.float32, device=dev)
    return _f32(c.lr, dev) * warm * mult


# ------------------------------------------------- 8-bit moment codec

def _q8_block(last_dim: int) -> int:
    """Largest divisor of the last dim <= BLOCK, so q keeps the param's
    exact shape."""
    for bs in range(min(BLOCK, last_dim), 0, -1):
        if last_dim % bs == 0:
            return bs
    return 1


def _q8_encode(x: torch.Tensor) -> dict:
    """Blockwise absmax int8 along the last dim.
    q: int8, same shape as x; scale: f32 (*x.shape[:-1], nblocks)."""
    d = x.shape[-1] if x.dim() else 1
    x = x.reshape(tuple(x.shape) or (1,))
    bs = _q8_block(d)
    nb = d // bs
    blocks = x.reshape(tuple(x.shape[:-1]) + (nb, bs))
    scale = _fma(float(np.float32(1.0) / np.float32(127.0)),
                 torch.amax(torch.abs(blocks), dim=-1, keepdim=True), 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale[..., 0].to(torch.float32)}


def _q8_decode(enc: dict, shape) -> torch.Tensor:
    q = enc["q"]
    scale = enc["scale"]
    nb = scale.shape[-1]
    bs = q.shape[-1] // nb
    blocks = q.reshape(tuple(q.shape[:-1]) + (nb, bs)).to(torch.float32)
    return (blocks * scale[..., None]).reshape(tuple(shape))


# ------------------------------------------------------------- adamw

def _is_moment(x) -> bool:
    return isinstance(x, dict) and "q" in x


def init_opt_state(params: dict, c: AdamWConfig) -> dict:
    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if c.moments_dtype == "int8":
            return _q8_encode(z)
        return z
    dev = T.leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": T.map_tree(zeros_like_moment, params),
        "v": T.map_tree(zeros_like_moment, params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum
    of squares, in float32."""
    total = 0
    for x in T.leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, c: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics); the
    inputs are not written."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    # a Python scalar over a tensor is a reciprocal times it in torch
    scale = torch.clamp(_f32(c.clip_norm, gnorm.device) / (gnorm + 1e-9), max=1.0)
    lr = schedule_fn(c, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(c.b1, step.device), stepf)
    b2c = 1 - torch.pow(_f32(c.b2, step.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        if c.moments_dtype == "int8":
            m_f = _q8_decode(m, p.shape)
            v_f = _q8_decode(v, p.shape)
        else:
            m_f, v_f = m, v
        if c.moments_dtype == "int8":     # XLA fuses the other product here
            m_f = _fma(1 - c.b1, g, c.b1 * m_f)
            v_f = _fma((1 - c.b2) * g, g, c.b2 * v_f)
        else:
            m_f = _fma(c.b1, m_f, (1 - c.b1) * g)
            v_f = _fma(c.b2, v_f, (1 - c.b2) * g * g)
        u = m_f / (b1c * (torch.sqrt(v_f / b2c) + c.eps))
        pf = p.to(torch.float32)
        new_p = _fma(-lr, _fma(c.weight_decay, pf, u), pf)
        if c.moments_dtype == "int8":
            return new_p.to(p.dtype), _q8_encode(m_f), _q8_encode(v_f)
        return new_p.to(p.dtype), m_f, v_f

    flat = T.flatten_with_path(params)
    paths = [p for p, _ in flat]
    leaves_g = T.leaves(grads)
    leaves_m = T.leaves(state["m"], _is_moment)
    leaves_v = T.leaves(state["v"], _is_moment)
    out = [upd(p, g, m, v) for (_, p), g, m, v in zip(flat, leaves_g, leaves_m, leaves_v)]
    new_params = T.unflatten(paths, [o[0] for o in out])
    new_state = {"step": step,
                 "m": T.unflatten(paths, [o[1] for o in out]),
                 "v": T.unflatten(paths, [o[2] for o in out])}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
