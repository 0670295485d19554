"""Deterministic, shardable, exactly-resumable synthetic token pipeline.

Real-cluster properties modeled faithfully:
  * host-sharded: each data-parallel host draws a disjoint stream
    (``shard_id / num_shards``),
  * exactly resumable: the full RNG state is (seed, step) — the cursor is
    checkpointed with the model (fault tolerance / elastic restart),
  * elastic: changing num_shards redistributes streams deterministically,
  * "documents": markov-chain token streams with EOS resets packed into
    fixed-length sequences (next-token labels), so losses follow a
    realistic decaying curve rather than memorizing noise.

The port's own copy of the reference's numpy pipeline: the same config
gives the same batches, bit for bit.  ``batch_at`` returns numpy arrays;
the training loop moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    eos_id: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, shard_id: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed markov structure (same for every shard — it's the "corpus")
        corpus_rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._succ = corpus_rng.integers(0, v, size=(v, 8))  # 8 likely successors

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, self.shard_id, self.num_shards, step))

    def batch_at(self, step: int) -> dict:
        """Stateless fetch — resume = batch_at(step); no hidden state."""
        c = self.cfg
        rng = self._rng_for(step)
        B, S = self.local_batch, c.seq_len
        toks = np.empty((B, S + 1), dtype=np.int32)
        cur = rng.integers(0, c.vocab, size=B)
        for t in range(S + 1):
            toks[:, t] = cur
            pick = rng.integers(0, 8, size=B)
            nxt = self._succ[cur, pick]
            # occasional EOS reset -> document boundaries
            reset = rng.random(B) < 0.01
            cur = np.where(reset, c.eos_id, nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
