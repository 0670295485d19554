"""Fault-tolerant training loop.

Every large-run mechanism is here, scaled to one device:
  * checkpoint every ``ckpt_every`` steps (async, atomic, verified),
  * resume-from-latest on (re)start — including the data cursor, so a
    killed job continues bit-exact,
  * step watchdog: wall-time per step is tracked; steps slower than
    ``straggler_factor`` x the running median are logged as stragglers,
  * data pipeline is stateless-resumable (batch_at(step)).

The reference draws its initial weights from ``jax.random``, which the
port cannot reproduce: ``train_loop`` draws them again from a
``torch.Generator`` seeded by ``seed`` on the model's device, or, with
``keep_weights=True``, starts from the weights the model already holds
(the reference's own, carried across by
``convert.params_from_reference``).  A checkpoint in ``ckpt_dir``
replaces either.  The model's parameters are trained in place.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import Model, init_params
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    straggler_factor: float = 3.0
    log_every: int = 10


def _load(model: Model, tree: dict) -> None:
    model.load_state_dict({".".join(p): v for p, v in T.flatten_with_path(tree)})


def train_loop(model: Model, tcfg: TrainConfig, lcfg: LoopConfig,
               data_cfg: DataConfig, seed: int = 0, verbose: bool = True,
               keep_weights: bool = False):
    """-> (the model's parameter tree, the train state, the losses of the
    steps this call ran)."""
    pipeline = TokenPipeline(data_cfg)
    step_fn = make_train_step(model, tcfg)
    device = model.device

    if not keep_weights:
        _load(model, init_params(model.cfg, torch.Generator(device=device).manual_seed(seed)))
    params = model.tree()
    state = init_train_state(model, params, tcfg)
    start_step = 0
    found = ckpt.restore_latest(lcfg.ckpt_dir, {"params": params, "state": state})
    if found is not None:
        s, restored = found
        _load(model, restored["params"])
        state = restored["state"]
        start_step = s
        if verbose:
            print(f"[loop] resumed from step {s}")

    saver = ckpt.AsyncCheckpointer(lcfg.ckpt_dir)
    times: list[float] = []
    losses: list[float] = []
    for step in range(start_step, lcfg.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipeline.batch_at(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)
        med = float(np.median(times[-50:]))
        if len(times) > 5 and dt > lcfg.straggler_factor * med and verbose:
            print(f"[watchdog] straggler step {step}: {dt:.2f}s vs median {med:.2f}s")
        if verbose and (step % lcfg.log_every == 0 or step == lcfg.steps - 1):
            print(f"[loop] step {step} loss {loss:.4f} ({dt:.2f}s)")
        if (step + 1) % lcfg.ckpt_every == 0 or step == lcfg.steps - 1:
            saver.save_async(step + 1, {"params": params, "state": state})
    saver.wait()
    return params, state, losses
