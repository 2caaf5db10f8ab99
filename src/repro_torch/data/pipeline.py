"""Deterministic sharded data pipeline.

Offline container => synthetic corpus, but with the properties a real
pipeline needs at 1000-node scale:

  * **Deterministic addressing**: batch `i` is a pure function of
    (seed, step, host) — any host can reproduce any batch, so restarts and
    elastic re-sharding never replay or skip data.
  * **Host sharding**: each host materializes only its slice of the global
    batch (`host_slice`), matching the (`pod`,`data`) mesh axes.
  * **Prefetch**: a depth-2 background iterator overlaps host data
    generation with device compute.
  * Markov-chain token stream (not uniform noise) so the LM loss actually
    decreases in the examples — useful for the end-to-end train driver.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    branching: int = 32   # Markov out-degree: lower => easier to model


class SyntheticTokens:
    """Deterministic Markov token stream, shardable by host."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse deterministic transition table: vocab x branching
        self.table = rng.integers(0, cfg.vocab,
                                  size=(cfg.vocab, cfg.branching),
                                  dtype=np.int32)

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch(self, step: int) -> dict:
        """The host's shard of global batch `step` (pure function)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index, 0xD5EE))
        b = self.host_batch
        toks = np.empty((b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        choices = rng.integers(0, cfg.branching, size=(b, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def prefetch(self, start_step: int = 0, depth: int = 2):
        """Background-producing iterator starting at `start_step`."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch(step)))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
