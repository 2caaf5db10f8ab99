"""The one traffic generator: it reads a mix's parameters
(`traffic/<mix>.json`) and makes token batches and arrival schedules from
`--seed`.

Tokens follow a Markov chain, a copy of the arithmetic of the port's
`data/pipeline.SyntheticTokens`: a (vocab, branching) transition table drawn
from the seed, and batch `step` drawn from (seed, step, 0, 0xD5EE), so a
batch is a pure function of (seed, step).  A serving mix's schedule of
arrivals and lengths is the mix's own (`serve_schedule`); the seed draws
the prompts' tokens and the sample that the reference checks.
"""

from __future__ import annotations

import math

import numpy as np


class Markov:
    """Deterministic Markov token stream (one host, no prefetch)."""

    def __init__(self, vocab: int, seed: int, branching: int = 32):
        self.vocab, self.seed, self.branching = vocab, seed, branching
        rng = np.random.default_rng(seed)
        self.table = rng.integers(0, vocab, size=(vocab, branching),
                                  dtype=np.int32)

    def rows(self, step: int, batch: int, length: int) -> np.ndarray:
        """(batch, length + 1) int32 tokens of batch `step`."""
        rng = np.random.default_rng((self.seed, step, 0, 0xD5EE))
        toks = np.empty((batch, length + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, self.branching, size=(batch, length))
        for t in range(length):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return toks

    def batch(self, step: int, batch: int, seq_len: int) -> dict:
        """Training batch `step`: tokens and next-token labels (B, S)."""
        toks = self.rows(step, batch, seq_len)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def prompts(self, index: int, batch: int, length: int) -> np.ndarray:
        """The prompts (B, length) of serving batch `index`."""
        return self.rows(index, batch, length)[:, :-1]


def serve_schedule(mix: dict, seconds: float) -> list[dict]:
    """Batches due in a window of `seconds`: {"index", "due" (s after the
    window opens), "length"}, an open loop (a batch is due whether or not
    the last one is done).  `arrivals` "poisson": the gaps are the
    exponential distribution's quantiles at (i + 1/2) / n for a mean of
    `mean_interval_s`, in an order drawn from `schedule_seed`; "even": one
    every `mean_interval_s`.  Lengths come in cycles that hold each of
    `lengths` once, also in orders from `schedule_seed`.  The schedule is
    the mix's alone, the same for every `--seed` (as a load generator with
    a fixed schedule seed replays one trace): a queue's tail depends on
    which lengths meet which bursts, and a seed that reordered them would
    change the work that the tail measures."""
    mean, lengths = mix["mean_interval_s"], list(mix["lengths"])
    n = max(1, math.ceil(seconds / mean))
    rng = np.random.default_rng((mix["schedule_seed"], 0x5E7E))
    if mix["arrivals"] == "poisson":
        gaps = rng.permutation(-mean * np.log1p(-(np.arange(n) + 0.5) / n))
    elif mix["arrivals"] == "even":
        gaps = np.full(n, mean)
    else:
        raise ValueError(f"arrivals {mix['arrivals']!r}: poisson or even")
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    order: list[int] = []
    while len(order) < n:
        order.extend(int(x) for x in rng.permutation(lengths))
    return [{"index": i, "due": float(due[i]), "length": order[i]}
            for i in range(n)]


def check_sample(schedule: list[dict], k: int, seed: int) -> list[int]:
    """Indices of the `k` batches whose answers the reference checks, drawn
    from the seed: one of each length the schedule holds (the longest among
    them), then others up to `k`."""
    rng = np.random.default_rng((seed, 0xC4EC))
    by_len: dict[int, list[int]] = {}
    for b in schedule:
        by_len.setdefault(b["length"], []).append(b["index"])
    pick = [int(rng.choice(ix)) for _, ix in sorted(by_len.items(),
                                                       reverse=True)][:k]
    rest = [b["index"] for b in schedule if b["index"] not in pick]
    more = rng.choice(len(rest), size=min(k - len(pick), len(rest)),
                      replace=False)
    return sorted(pick + [rest[int(i)] for i in more])
