"""Batched greedy serving: prefill + decode over a ``Model`` in waves of
a fixed batch.

``make_serve_fns`` returns the two step functions (prefill_step for
prefill shapes, decode_step for decode shapes).  The steps run eagerly.

``ServeEngine.run`` keeps the reference engine's behaviour exactly,
quirks included: requests are taken in waves of ``batch_size``; prompts
are right-padded with token 0 and every row's first token is read at
position S-1 of the padded prompt; the wave shares one cache length;
greedy ``argmax`` over ``[:, :cfg.vocab]``; tokens are appended to
``Request.out``; the wave decodes ``max(max_new)`` steps, the last of
which only feeds a token no request keeps.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.model import Model


def make_serve_fns(model: Model):
    def prefill_step(batch):
        return model.prefill(batch)

    def decode_step(cache, batch):
        return model.decode_step(cache, batch)

    return prefill_step, decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Greedy-decoding batch engine.  ``waves`` records, per wave of the
    last ``run``, its batch, padded prompt length, decode steps and the
    host-clock seconds of its prefill (to the first tokens on the host)
    and of its decode steps."""

    def __init__(self, model: Model, batch_size: int, max_len: int):
        self.model = model
        self.batch_size = batch_size
        self.max_len = max_len
        self._prefill, self._decode = make_serve_fns(model)
        self.waves: list[dict] = []

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        cfg = self.model.cfg
        device = self.model.device
        out: dict[int, list[int]] = {}
        self.waves = []
        queue = list(requests)
        while queue:
            active = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            S = max(len(r.prompt) for r in active)
            B = len(active)
            toks = np.zeros((B, S), np.int64)
            for i, r in enumerate(active):     # right-padded with 0, as the reference
                toks[i, : len(r.prompt)] = r.prompt
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(toks).to(device),
                     "max_len": self.max_len}
            logits, cache = self._prefill(batch)
            nxt = torch.argmax(logits[:, : cfg.vocab], dim=-1)
            host = nxt.tolist()
            t1 = time.perf_counter()
            steps = max(r.max_new for r in active)
            for _ in range(steps):
                for i, r in enumerate(active):
                    if len(r.out) < r.max_new:
                        r.out.append(int(host[i]))
                logits, cache = self._decode(cache, {"tokens": nxt[:, None]})
                nxt = torch.argmax(logits[:, : cfg.vocab], dim=-1)
                host = nxt.tolist()
            t2 = time.perf_counter()
            self.waves.append({"batch": B, "prompt_len": S, "steps": steps,
                               "prefill_s": t1 - t0, "decode_s": t2 - t1})
            for r in active:
                out[r.rid] = r.out
        return out
