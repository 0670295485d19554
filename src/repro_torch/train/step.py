"""The train step: loss -> grads (with optional microbatch grad
accumulation and int8 gradient compression w/ error feedback) -> AdamW.

``make_train_step(model, tcfg)`` sets the model's remat policy and
returns ``train_step(state, batch) -> (state, metrics)``: autograd's
gradients of ``model.loss_fn`` (summed over the microbatches in their
order, then divided by their count), the reference's AdamW, and the new
parameters written into the model's own in place.  ``state`` is the
reference's tree (``{"opt": {"step", "m", "v"}}``, plus ``"err"`` under
``int8_ef``); the metrics are float32 tensors ``loss``, ``grad_norm``
and ``lr``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T
from repro_torch.models.model import Model
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1            # grad accumulation steps
    remat_policy: str = "full"
    grad_compression: str = "none"   # none | bf16 | int8_ef


def _compress_grads(grads, err, mode: str):
    """Gradient compression with error feedback.  Models the cross-pod
    (DCN) compressed all-reduce: quantize g+err, carry the residual."""
    if mode == "none":
        return grads, err
    if mode == "bf16":
        q = T.map_tree(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        new_err = T.map_tree(lambda g, qq: g - qq, grads, q)
        return q, new_err

    def q8(g, e):
        t = g.to(torch.float32) + e
        scale = adamw._div_const(torch.amax(torch.abs(t)), 127.0) + 1e-12
        q = torch.clamp(torch.round(t / scale), -127, 127)
        # t - q * scale is one fused multiply-add in the reference's jit
        return q * scale, adamw._fma(scale, -q, t)
    pairs = T.map_tree(q8, grads, err)
    is_pair = lambda x: isinstance(x, tuple)
    return (T.map_tree(lambda p: p[0], pairs, is_leaf=is_pair),
            T.map_tree(lambda p: p[1], pairs, is_leaf=is_pair))


def init_train_state(model: Model, params: dict, tcfg: TrainConfig) -> dict:
    state = {"opt": adamw.init_opt_state(params, tcfg.opt)}
    if tcfg.grad_compression == "int8_ef":
        state["err"] = T.map_tree(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def make_train_step(model: Model, tcfg: TrainConfig):
    model.remat_policy = tcfg.remat_policy

    def train_step(state: dict, batch: dict):
        mb = tcfg.microbatches
        params = model.tree()
        plist = T.leaves(params)
        for p in plist:
            p.grad = None
        if mb == 1:
            loss, _ = model.loss_fn(batch)
            loss.backward()
            loss = loss.detach()
        else:
            micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(mb):           # .grad accumulates in this order
                l, _ = model.loss_fn({k: v[i] for k, v in micro.items()})
                l.backward()
                loss = loss + l.detach()
            loss = adamw._div_const(loss, mb)
        # a parameter the loss does not reach has a zero gradient, as in jax
        gl = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
        grads = T.unflatten([p for p, _ in T.flatten_with_path(params)],
                            gl if mb == 1 else [adamw._div_const(g, mb) for g in gl])
        for p in plist:
            p.grad = None
        if tcfg.grad_compression != "none":
            err = state.get("err", T.map_tree(torch.zeros_like, grads))
            grads, err = _compress_grads(grads, err, tcfg.grad_compression)
        new_params, opt, metrics = adamw.apply_updates(params, grads, state["opt"], tcfg.opt)
        with torch.no_grad():
            for p, new in zip(plist, T.leaves(new_params)):
                p.copy_(new)
        new_state = {"opt": opt}
        if tcfg.grad_compression == "int8_ef":
            new_state["err"] = err
        return new_state, {"loss": loss, **metrics}

    return train_step
