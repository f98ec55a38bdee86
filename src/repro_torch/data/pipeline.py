"""Deterministic synthetic LM data pipeline: sharded, resumable, prefetched.

A copy of ``repro.data.pipeline`` (NumPy only): the batch at a step is
the same for the same (seed, step, shard) in both packages.

Real-cluster properties this reproduces:
  * determinism: batch at step t is a pure function of (seed, step) --
    restart/elastic-resize replays the exact token stream;
  * sharding: each data-parallel rank materializes only its slice;
  * checkpointable state: the iterator state is just the step counter;
  * prefetch: a background thread keeps a small queue of ready batches.

Tokens are Zipf-distributed (vocabulary rank-frequency ~ 1/k) so losses
have realistic structure (a uniform stream makes every model converge to
the same trivial entropy).  Labels are next-token targets with the final
position masked.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1
    memory_tokens: int = 0      # stub frontend length (vlm/encdec)
    d_model: int = 0


class SyntheticLM:
    """Deterministic synthetic token stream."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.step = 0

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict):
        self.step = int(state["step"])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard])
        )
        # Zipf over vocab, clipped; rejection-free via inverse-CDF on ranks
        u = rng.random((self.local_batch, cfg.seq_len))
        ranks = np.floor(
            (u * (cfg.vocab ** (cfg.zipf_a - 1.0) - 1) + 1)
            ** (1.0 / (cfg.zipf_a - 1.0))
        ).astype(np.int64)
        tokens = np.clip(ranks - 1, 0, cfg.vocab - 1).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.local_batch, 1), -100, np.int32)], axis=1
        )
        out = {"tokens": tokens, "labels": labels}
        if cfg.memory_tokens:
            out["memory_embeds"] = rng.normal(
                size=(self.local_batch, cfg.memory_tokens, cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.dead = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for b in self.it:
                if self.dead:
                    return
                self.q.put(b)
        except Exception as e:  # pragma: no cover
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self.dead = True
