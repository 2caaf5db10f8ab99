"""Trace-driven cache simulation — the GPGPU-Sim replacement (iso-area).

Two engines:

  * `SetAssocCache` — an exact set-associative LRU write-back simulator.
    Used by the property tests to validate the analytic model, and usable
    directly on small traces.
  * `stack_distance_profile` — single-pass LRU stack-distance histogram
    (Mattson).  One pass over a trace yields the miss count for EVERY
    capacity simultaneously, which is how the Fig. 6 capacity sweep is
    produced cheaply.

Traces are sequences of block ids (ints) at a configurable granularity;
`trace_from_streams` lowers the analytic AccessStream representation into a
concrete interleaved trace for cross-validation.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from collections.abc import Iterable, Sequence


@dataclasses.dataclass
class CacheStats:
    accesses: int = 0
    misses: int = 0
    writebacks: int = 0

    @property
    def miss_rate(self) -> float:
        return self.misses / max(1, self.accesses)


class SetAssocCache:
    """Exact set-associative LRU write-back cache (one block granularity)."""

    def __init__(self, capacity_blocks: int, assoc: int = 16):
        if capacity_blocks < 1:
            raise ValueError(f"capacity_blocks must be >= 1, got {capacity_blocks}")
        if assoc < 1:
            raise ValueError(f"assoc must be >= 1, got {assoc}")
        # capacity below one full set degrades to fully-associative at the
        # available capacity (never to an empty set, which would make
        # access() pop a victim from an empty OrderedDict)
        assoc = min(assoc, capacity_blocks)
        self.n_sets = max(1, capacity_blocks // assoc)
        self.assoc = assoc
        self.sets: list[OrderedDict[int, bool]] = [
            OrderedDict() for _ in range(self.n_sets)]
        self.stats = CacheStats()

    def access(self, block: int, is_write: bool = False) -> bool:
        """Returns True on hit."""
        s = self.sets[block % self.n_sets]
        self.stats.accesses += 1
        if block in s:
            s[block] = s[block] or is_write
            s.move_to_end(block)
            return True
        self.stats.misses += 1
        if len(s) >= self.assoc:
            _victim, dirty = s.popitem(last=False)
            if dirty:
                self.stats.writebacks += 1
        s[block] = is_write
        return False

    def run(self, trace: Iterable[tuple[int, bool]]) -> CacheStats:
        for block, is_write in trace:
            self.access(block, is_write)
        return self.stats


def stack_distance_profile(trace: Sequence[int]) -> list[int]:
    """LRU stack distances for each access (-1 = cold miss).

    O(N * unique) with a movable list; fine for the trace sizes we lower
    (the analytic model handles the big workloads)."""
    stack: list[int] = []
    seen: set[int] = set()
    out: list[int] = []
    for block in trace:
        if block in seen:
            idx = stack.index(block)  # distance from the top
            out.append(idx)
            stack.pop(idx)
        else:
            out.append(-1)
            seen.add(block)
        stack.insert(0, block)
    return out


def misses_at_capacity(distances: Sequence[int], capacity_blocks: int) -> int:
    """Fully-associative LRU misses from a stack-distance profile."""
    return sum(1 for d in distances if d < 0 or d >= capacity_blocks)


def trace_from_streams(streams, block_bytes: int = 4096,
                       max_blocks_per_stream: int = 512) -> list[tuple[int, bool]]:
    """Lower AccessStreams into a concrete interleaved block trace.

    Each stream becomes a region of block ids touched sequentially along a
    byte timeline (the primary pass, streams laid out back to back); a
    stream with finite reuse distance R re-touches each of its blocks R
    bytes of primary traffic after the first touch, so a cache holding more
    than ~R bytes turns the re-touch into a hit — the semantics the
    analytic dram_tx miss curve assigns to R.  Streaming streams (R = inf)
    are touched once and never again.  Approximate by construction — used
    for cross-validating the analytic model on scaled-down workloads."""
    events: list[tuple[float, int, int, bool]] = []  # (byte pos, seq, block, w)
    next_base = 0
    pos = 0.0  # primary-pass byte cursor
    seq = 0
    for s in streams:
        n = min(max_blocks_per_stream,
                max(1, int(s.bytes_total // block_bytes)))
        for block in range(next_base, next_base + n):
            events.append((pos, seq, block, s.is_write))
            seq += 1
            if math.isfinite(s.reuse_distance):
                events.append((pos + s.reuse_distance, seq, block, s.is_write))
                seq += 1
            pos += block_bytes
        next_base += n
    events.sort(key=lambda e: (e[0], e[1]))
    return [(block, is_write) for _, _, block, is_write in events]
