"""Batched workload-evaluation engine — the architecture-layer fold as one
tensor computation.

core/engine.py batches the circuit layer (the NVSim tech x capacity x
organization sweep); this module batches the layer DeepNVM++ stacks on top
of it: folding workload memory traffic through tuned cache designs to get
runtime, dynamic/leakage/DRAM energy, and EDP (paper Figs. 3-10).  The
scalar path (``traffic.runtime`` / ``traffic.energy``, one call per
(workload, memory, capacity)) survives as the parity reference, pinned by
tests/test_workload_engine.py to a few ulps.

Representation: structure-of-arrays, padded.  Every scenario — one
``TrafficStats``, i.e. one (workload, batch, training) execution — packs
its ``AccessStream`` tuple into rows of four [scenario, stream] tensors
(``bytes_total``, ``is_write``, ``reuse_distance``, ``dram_visible``) with
a stream-count ``mask`` marking real entries (padding rows carry zero
bytes, infinite reuse distance, and a False mask, so they contribute
nothing to any fold).  Designs — (memory, capacity) points read from
``engine.DesignTable`` — pack into five [design] vectors.  One float64
torch function then evaluates the full cross product, on the pipeline's
device (``cuda`` unless the caller passes ``device="cpu"``),

    [scenario] x [design]  ->  runtime / energy / EDP tensors [s, d]

reproducing the scalar path's operation order exactly: the miss-curve
``dram_tx`` fold, the \"simple model\" runtime (compute + serialized L2 +
DRAM stall), and the dynamic/leakage/DRAM energy terms.

The platform is itself a batched axis: ``evaluate_platforms`` evaluates

    [platform] x [scenario] x [design]

in one call (platform parameters are a [p, 4] runtime input, so e.g.
GTX_1080TI vs TPU_V5E share one evaluation), returning one
:class:`WorkloadTable` view per platform.  Platform-independent tensors
(L2 transactions, DRAM transactions, dynamic energy) are computed once
and shared across the views.

:class:`WorkloadTable` wraps the result tensors, brought back to the host
as float64 numpy arrays, with the same vocabulary the scalar API uses
(``total_j``/``edp``/``EnergyReport``), and ``evaluate`` memoizes tables
per (scenarios, designs, platforms, device) so the
iso-capacity, iso-area, and scaling analyses plus the benchmarks all share
one evaluation — the whole cross-layer pipeline becomes two composed
batched computations (circuit sweep, workload fold).
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core import device as device_mod
from repro_torch.core import traffic
from repro_torch.core.cachemodel import LINE_BYTES, CacheDesign
from repro_torch.core.tech import Platform, GTX_1080TI
from repro_torch.core.traffic import (
    ASSOC_EFFICIENCY,
    COMPUTE_EFFICIENCY,
    MISS_CURVE_P,
    EnergyReport,
    TrafficStats,
)
from repro_torch.core.workloads import Workload

# Platform parameters consumed by the fold, in the order they are packed
# into the platform vector (a runtime input).
PLATFORM_FIELDS = ("peak_flops", "mem_serialization", "dram_bw",
                   "dram_energy_per_byte")

@functools.lru_cache(maxsize=None)
def stats_for(workload: Workload, batch: int, training: bool) -> TrafficStats:
    """Memoized ``traffic.build`` — scenarios are shared across analyses."""
    return traffic.build(workload, batch, training)


# ---------------------------------------------------------------------------
# Packing: AccessStreams -> padded SoA tensors, designs -> vectors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class StreamBatch:
    """Padded structure-of-arrays pack of many scenarios' AccessStreams."""

    keys: tuple[tuple[str, int, bool], ...]  # (workload, batch, training)
    bytes_total: np.ndarray     # [s, k] float64, padded 0.0
    is_write: np.ndarray        # [s, k] bool,    padded False
    reuse_distance: np.ndarray  # [s, k] float64, padded inf
    dram_visible: np.ndarray    # [s, k] bool,    padded False
    mask: np.ndarray            # [s, k] bool — True on real streams
    macs: np.ndarray            # [s] float64


def pad_width(k: int) -> int:
    """Pack-width bucket: the next power of two >= k (minimum 8).

    The chunked sweep path pads each chunk to a bucket instead of its
    exact stream-count maximum, so chunks with nearby widths share one
    fold shape (and can stack into one batch); relative padding waste
    stays < 2x while the number of distinct shapes stays O(log max_k)."""
    if k < 1:
        raise ValueError("pad_width needs k >= 1")
    w = 8
    while w < k:
        w *= 2
    return w


# Scenario/design axis-bucket floors of the bucketed (service) fold path:
# requests below the floor share the floor's shape.
S_BUCKET_FLOOR = 4
D_BUCKET_FLOOR = 4


def axis_bucket(n: int, floor: int = 1) -> int:
    """Batch-axis shape bucket: the next power of two >= max(n, floor).

    The ``pad_width`` idea generalized to the scenario and design axes —
    the bucketed fold pads every axis to its bucket, so the set of fold
    shapes stays O(log^3) over arbitrary request sizes (the property that
    lets ``warmup`` run them all ahead of a request)."""
    if n < 1:
        raise ValueError("axis_bucket needs n >= 1")
    w = max(1, floor)
    while w < n:
        w *= 2
    return w


def pack(stats_seq: Sequence[TrafficStats],
         width: int | None = None) -> StreamBatch:
    """Pack scenarios into padded [scenario, stream] tensors.

    ``width`` overrides the padded stream-axis size (default: the max
    stream count across *these* scenarios).  The sharded sweep path packs
    per chunk — so one outlier scenario (e.g. googlenet train, 645
    streams) widens only its own chunk, not every chunk of the sweep; a
    global pack pads every scenario row to the global max and is the
    memory blowup that makes mixed mega-specs OOM earlier than cell count
    alone predicts.  Padding rows carry zero bytes, infinite reuse
    distance, and a False mask, so any width gives the same fold result.
    """
    stats_seq = tuple(stats_seq)
    k = max(len(s.streams) for s in stats_seq)
    if width is not None:
        if width < k:
            raise ValueError(f"width {width} < max stream count {k}")
        k = width
    n = len(stats_seq)
    bytes_total = np.zeros((n, k), dtype=np.float64)
    is_write = np.zeros((n, k), dtype=bool)
    reuse = np.full((n, k), np.inf, dtype=np.float64)
    visible = np.zeros((n, k), dtype=bool)
    mask = np.zeros((n, k), dtype=bool)
    for i, stats in enumerate(stats_seq):
        a = stats._arrays
        m = len(stats.streams)
        bytes_total[i, :m] = a["bytes_total"]
        is_write[i, :m] = a["is_write"]
        reuse[i, :m] = a["reuse_distance"]
        visible[i, :m] = a["dram_visible"]
        mask[i, :m] = True
    return StreamBatch(
        keys=tuple((s.workload, s.batch, s.training) for s in stats_seq),
        bytes_total=bytes_total, is_write=is_write, reuse_distance=reuse,
        dram_visible=visible, mask=mask,
        macs=np.array([s.macs_per_batch for s in stats_seq],
                      dtype=np.float64),
    )


def _design_vectors(designs: Sequence[CacheDesign]) -> tuple[np.ndarray, ...]:
    def as_vec(field: str) -> np.ndarray:
        return np.array([getattr(d, field) for d in designs], dtype=np.float64)

    return (as_vec("read_latency_s"), as_vec("write_latency_s"),
            as_vec("read_energy_j"), as_vec("write_energy_j"),
            as_vec("leakage_w"), as_vec("capacity_bytes"))


def _platform_vector(platform: Platform) -> np.ndarray:
    return np.array([getattr(platform, f) for f in PLATFORM_FIELDS],
                    dtype=np.float64)


# ---------------------------------------------------------------------------
# The fold (torch, float64, on the pipeline's device)
# ---------------------------------------------------------------------------


def _miss_tx(bytes_total, rd, visible, caps):
    """[s, c] DRAM transactions — TrafficStats.dram_tx's fold, batched.

    Each stream misses with probability (RD / (RD + C_eff))^MISS_CURVE_P
    (RD=inf always misses); only DRAM-visible streams count.
    """
    c_eff = caps * ASSOC_EFFICIENCY                       # [c]
    r = rd[:, None, :]                                    # [s, 1, k]
    ratio = r / (r + c_eff[None, :, None])
    miss_p = torch.where(torch.isinf(r), 1.0, ratio ** MISS_CURVE_P)
    tx = bytes_total[:, None, :] / LINE_BYTES * miss_p
    return torch.where(visible[:, None, :], tx, 0.0).sum(dim=2)


def _fold(bytes_total, is_write, rd, visible, mask, macs,
          rl, wl, re_, we_, leak, caps, pmat):
    """The full [platform] x [scenario] x [design] workload fold.

    Streams [s, k], designs [d], platforms [p, 4] (float64 / bool tensors
    on one device) -> platform-dependent float64 metric tensors [p, s, d]
    plus platform-independent [s] / [s, d] ones.  Every expression keeps
    the scalar traffic.runtime/energy operation order so float64 results
    match the Python reference to the last ulps.
    """
    peak_flops = pmat[:, 0][:, None, None]       # [p, 1, 1]
    serialization = pmat[:, 1][:, None, None]
    dram_bw = pmat[:, 2][:, None, None]
    dram_epb = pmat[:, 3][:, None, None]
    bt = torch.where(mask, bytes_total, 0.0)
    read_tx = torch.where(is_write, 0.0, bt).sum(dim=1) / LINE_BYTES  # [s]
    write_tx = torch.where(is_write, bt, 0.0).sum(dim=1) / LINE_BYTES
    dram_tx = _miss_tx(bt, rd, visible & mask, caps)                  # [s, d]

    t_compute = macs[None, :, None] * 2.0 \
        / (peak_flops * COMPUTE_EFFICIENCY)                           # [p, s, 1]
    t_l2 = read_tx[:, None] * rl[None, :] + write_tx[:, None] * wl[None, :]
    runtime_nodram = t_compute + serialization * t_l2[None]           # [p, s, d]
    runtime = runtime_nodram + (dram_tx * LINE_BYTES)[None] / dram_bw

    return dict(
        l2_read_tx=read_tx,
        l2_write_tx=write_tx,
        dram_tx=dram_tx,
        runtime_s=runtime,
        runtime_nodram_s=runtime_nodram,
        dyn_read_j=read_tx[:, None] * re_[None, :],
        dyn_write_j=write_tx[:, None] * we_[None, :],
        leak_j=leak[None, None, :] * runtime,
        leak_nodram_j=leak[None, None, :] * runtime_nodram,
        dram_j=(dram_tx * LINE_BYTES)[None] * dram_epb,
    )


def _run_fold(device: str, *arrays) -> dict[str, np.ndarray]:
    """``_fold`` on ``device`` over the numpy inputs, outputs on the host."""
    out = _fold(*(device_mod.put(a, device) for a in arrays))
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Result table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class WorkloadTable:
    """Evaluated [scenario] x [design] workload fold.

    Scenario axis: (workload, batch, training) keys in pack order.  Design
    axis: the CacheDesign points (typically EDAP-tuned reads of an
    ``engine.DesignTable``).  ``runtime_s``/``leak_j`` include the DRAM
    stall term (the scalar path's ``include_dram=True`` default); the
    ``*_nodram`` variants mirror ``include_dram=False``.
    """

    scenarios: tuple[tuple[str, int, bool], ...]
    designs: tuple[CacheDesign, ...]
    platform: Platform
    l2_read_tx: np.ndarray      # [s]
    l2_write_tx: np.ndarray     # [s]
    dram_tx: np.ndarray         # [s, d]
    runtime_s: np.ndarray       # [s, d]
    runtime_nodram_s: np.ndarray
    dyn_read_j: np.ndarray
    dyn_write_j: np.ndarray
    leak_j: np.ndarray
    leak_nodram_j: np.ndarray
    dram_j: np.ndarray

    # -- indexing ----------------------------------------------------------

    def scenario_index(self, workload: str, batch: int, training: bool) -> int:
        return self.scenarios.index((workload, batch, training))

    def design_index(self, mem: str, capacity_bytes: int | None = None) -> int:
        matches = [j for j, d in enumerate(self.designs)
                   if d.mem == mem
                   and capacity_bytes in (None, d.capacity_bytes)]
        if not matches:
            raise ValueError(f"no design ({mem}, {capacity_bytes}) in table")
        if len(matches) > 1:
            if capacity_bytes is None:
                raise ValueError(f"{mem!r} appears at several capacities; "
                                 "pass capacity_bytes")
            # duplicate (mem, capacity) designs — e.g. the same corner at
            # two technology nodes — cannot be told apart here; never
            # silently return the first (SweepResult.design_index parity)
            raise ValueError(f"several designs match ({mem}, "
                             f"{capacity_bytes}); look them up by index")
        return matches[0]

    @property
    def read_write_ratio(self) -> np.ndarray:
        return self.l2_read_tx / np.maximum(1.0, self.l2_write_tx)

    # -- derived metric tensors (scalar EnergyReport operation order) ------

    @property
    def dyn_j(self) -> np.ndarray:
        return self.dyn_read_j + self.dyn_write_j

    def total_j(self, include_dram: bool = False) -> np.ndarray:
        total = self.dyn_j + self.leak_j
        return total + self.dram_j if include_dram else total

    def edp(self, include_dram: bool = False) -> np.ndarray:
        return self.total_j(include_dram) * self.runtime_s

    def metric(self, name: str, include_dram: bool = False) -> np.ndarray:
        """[s, d] tensor of one IsoCapRow.norm metric."""
        return {
            "dyn": lambda: self.dyn_j,
            "leak": lambda: self.leak_j,
            "energy": lambda: self.total_j(include_dram),
            "edp": lambda: self.edp(include_dram),
            "runtime": lambda: self.runtime_s,
        }[name]()

    def norm(self, name: str, mem: str, baseline: str = "sram",
             include_dram: bool = False) -> np.ndarray:
        """[s] metric of `mem`'s design normalized to the baseline design
        (the paper's figure convention; designs looked up by memory)."""
        m = self.metric(name, include_dram)
        return m[:, self.design_index(mem)] / m[:, self.design_index(baseline)]

    # -- scalar-API materialization ----------------------------------------

    def report(self, scenario_index: int, design_index: int) -> EnergyReport:
        """One (scenario, design) cell as the scalar-API EnergyReport."""
        s, d = scenario_index, design_index
        return EnergyReport(
            workload=self.scenarios[s][0],
            mem=self.designs[d].mem,
            runtime_s=float(self.runtime_s[s, d]),
            dyn_read_j=float(self.dyn_read_j[s, d]),
            dyn_write_j=float(self.dyn_write_j[s, d]),
            leak_j=float(self.leak_j[s, d]),
            dram_j=float(self.dram_j[s, d]),
        )

    def reports(self, scenario_index: int) -> dict[str, EnergyReport]:
        """All designs of one scenario, keyed by memory technology (the
        IsoCapRow shape — requires memory-unique designs)."""
        out = {d.mem: self.report(scenario_index, j)
               for j, d in enumerate(self.designs)}
        if len(out) != len(self.designs):
            raise ValueError("designs are not memory-unique; key by index")
        return out


# ---------------------------------------------------------------------------
# Evaluation entry points (memoized, like engine.design_table)
# ---------------------------------------------------------------------------


# Result-tensor names that carry a leading platform axis in the kernel
# output; the rest are platform-independent and shared across the views.
_PLATFORM_DEPENDENT = ("runtime_s", "runtime_nodram_s", "leak_j",
                       "leak_nodram_j", "dram_j")


def _tables_from(out: dict, keys, designs, platforms,
                 ) -> tuple[WorkloadTable, ...]:
    """One WorkloadTable view per platform from the fold's output dict."""
    shared = {k: v for k, v in out.items() if k not in _PLATFORM_DEPENDENT}
    return tuple(
        WorkloadTable(scenarios=keys, designs=designs, platform=p,
                      **shared,
                      **{k: out[k][i] for k in _PLATFORM_DEPENDENT})
        for i, p in enumerate(platforms))


@functools.lru_cache(maxsize=None)
def _evaluate_cached(stats_seq: tuple[TrafficStats, ...],
                     designs: tuple[CacheDesign, ...],
                     platforms: tuple[Platform, ...],
                     device: str,
                     ) -> tuple[WorkloadTable, ...]:
    batch = pack(stats_seq)
    pmat = np.stack([_platform_vector(p) for p in platforms])
    out = _run_fold(device, batch.bytes_total, batch.is_write,
                    batch.reuse_distance, batch.dram_visible, batch.mask,
                    batch.macs, *_design_vectors(designs), pmat)
    return _tables_from(out, batch.keys, designs, platforms)


def evaluate(stats_seq: Sequence[TrafficStats],
             designs: Sequence[CacheDesign],
             platform: Platform = GTX_1080TI,
             device="cuda") -> WorkloadTable:
    """Evaluate the [scenario] x [design] cross product as one batched
    computation.  Memoized per (scenarios, designs, platforms, device), so
    every consumer of the same fold shares one evaluation."""
    return evaluate_platforms(stats_seq, designs, (platform,), device)[0]


def evaluate_platforms(stats_seq: Sequence[TrafficStats],
                       designs: Sequence[CacheDesign],
                       platforms: Sequence[Platform] = (GTX_1080TI,),
                       device="cuda",
                       ) -> tuple[WorkloadTable, ...]:
    """Evaluate the full [platform] x [scenario] x [design] cross product
    as one batched call on ``device`` and return one WorkloadTable view per
    platform (platform-independent tensors are shared between views)."""
    return _evaluate_cached(tuple(stats_seq), tuple(designs),
                            tuple(platforms), device_mod.resolve(device))


# ---------------------------------------------------------------------------
# Chunk-aware evaluation (sharded mega-sweeps, core/sweep.py ShardPlan)
# ---------------------------------------------------------------------------


def evaluate_chunk(stats_seq: Sequence[TrafficStats],
                   designs: Sequence[CacheDesign],
                   platforms: Sequence[Platform] = (GTX_1080TI,),
                   width: int | None = None,
                   device="cuda",
                   ) -> tuple[WorkloadTable, ...]:
    """One chunk of a sharded sweep: like ``evaluate_platforms`` but
    deliberately **uncached** — a mega-sweep evaluates thousands of chunks
    and pinning every chunk's tensors in the lru memo would unbound peak
    memory — and packed to the chunk's own (bucketed) stream width, so an
    outlier-wide scenario inflates only the chunk that contains it."""
    device = device_mod.resolve(device)
    stats_seq = tuple(stats_seq)
    designs = tuple(designs)
    if width is None:
        width = pad_width(max(len(s.streams) for s in stats_seq))
    batch = pack(stats_seq, width=width)
    pmat = np.stack([_platform_vector(p) for p in platforms])
    out = _run_fold(device, batch.bytes_total, batch.is_write,
                    batch.reuse_distance, batch.dram_visible, batch.mask,
                    batch.macs, *_design_vectors(designs), pmat)
    return _tables_from(out, batch.keys, designs, tuple(platforms))


def evaluate_chunk_group(chunk_stats: Sequence[Sequence[TrafficStats]],
                         chunk_designs: Sequence[Sequence[CacheDesign]],
                         platforms: Sequence[Platform],
                         device="cuda") -> list[tuple[WorkloadTable, ...]]:
    """Evaluate a group of same-shaped chunks as one stacked batch on one
    device (uncached, like ``evaluate_chunk``): every input gains a leading
    chunk axis, the platform matrix is shared, and the fold is mapped over
    the chunk axis — it has no cross-chunk terms.

    All chunks must agree on scenario and design counts (the sharded
    lowering groups them so); the group packs to one shared (bucketed)
    stream width.  Returns the per-chunk WorkloadTable views, in order.
    """
    device = device_mod.resolve(device)
    g = len(chunk_stats)
    if g < 1:
        raise ValueError("a chunk group needs at least one chunk")
    if len({len(cs) for cs in chunk_stats}) != 1 or \
            len({len(cd) for cd in chunk_designs}) != 1:
        raise ValueError("chunks in a sharded group must share scenario "
                         "and design counts")
    width = pad_width(max(len(s.streams)
                          for cs in chunk_stats for s in cs))
    batches = [pack(tuple(cs), width=width) for cs in chunk_stats]
    stacked = [np.stack([getattr(b, f) for b in batches])
               for f in ("bytes_total", "is_write", "reuse_distance",
                         "dram_visible", "mask", "macs")]
    vecs = [np.stack(v) for v in
            zip(*(_design_vectors(tuple(cd)) for cd in chunk_designs))]
    pmat = np.stack([_platform_vector(p) for p in platforms])
    fold = torch.func.vmap(_fold, in_dims=(0,) * 12 + (None,))
    out = fold(*(device_mod.put(a, device) for a in stacked + vecs),
               device_mod.put(pmat, device))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return [_tables_from({k: v[i] for k, v in out.items()},
                         batches[i].keys, tuple(chunk_designs[i]),
                         tuple(platforms))
            for i in range(g)]


# ---------------------------------------------------------------------------
# Bucketed evaluation + warmup (the concurrent sweep service's fold path)
# ---------------------------------------------------------------------------


def _pad_axis(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad the leading axis of ``a`` to length ``n`` with ``fill``."""
    if a.shape[0] == n:
        return a
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def evaluate_bucketed(stats_seq: Sequence[TrafficStats],
                      designs: Sequence[CacheDesign],
                      platforms: Sequence[Platform] = (GTX_1080TI,),
                      device="cuda",
                      ) -> tuple[WorkloadTable, ...]:
    """Shape-bucketed, uncached fold — the sweep service's evaluation path.

    Pads the scenario axis, the design axis, and the stream width each to
    its power-of-two bucket and slices the real cells back out of the
    fold's output.  Padding is inert by construction: scenario rows carry
    zero bytes, infinite reuse distance, zero MACs, and a False mask;
    design columns are all-zero vectors (zero capacity means every stream
    misses, but the column is dropped before anything reads it).  The set
    of fold shapes is therefore O(log^3) over arbitrary request sizes —
    exactly the shapes :func:`warmup` runs ahead of a request.

    Values match ``evaluate_platforms`` at <= 1e-12 relative (padding
    reassociates the stream reductions, so bit-identity is not claimed).
    Deliberately uncached like ``evaluate_chunk``: the service layers its
    own bounded result cache on top.
    """
    device = device_mod.resolve(device)
    stats_seq = tuple(stats_seq)
    designs = tuple(designs)
    platforms = tuple(platforms)
    s, d = len(stats_seq), len(designs)
    sp = axis_bucket(s, S_BUCKET_FLOOR)
    dp = axis_bucket(d, D_BUCKET_FLOOR)
    width = pad_width(max(len(x.streams) for x in stats_seq))
    batch = pack(stats_seq, width=width)
    bt = _pad_axis(batch.bytes_total, sp, 0.0)
    iw = _pad_axis(batch.is_write, sp, False)
    rd = _pad_axis(batch.reuse_distance, sp, np.inf)
    vis = _pad_axis(batch.dram_visible, sp, False)
    mask = _pad_axis(batch.mask, sp, False)
    macs = _pad_axis(batch.macs, sp, 0.0)
    vecs = [np.pad(v, (0, dp - d)) for v in _design_vectors(designs)]
    pmat = np.stack([_platform_vector(p) for p in platforms])
    out = _run_fold(device, bt, iw, rd, vis, mask, macs, *vecs, pmat)
    sliced = {}
    for k, v in out.items():
        if v.ndim == 1:                 # [s] platform-independent
            sliced[k] = v[:s]
        elif v.ndim == 2:               # [s, d] platform-independent
            sliced[k] = v[:s, :d]
        else:                           # [p, s, d]
            sliced[k] = v[:, :s, :d]
    return _tables_from(sliced, batch.keys, designs, platforms)


def fold_shape(n_scenarios: int, max_streams: int, n_designs: int,
               n_platforms: int) -> tuple[int, int, int, int]:
    """The (s, k, d, p) fold shape ``evaluate_bucketed`` runs for these
    axis sizes — the unit of warmup."""
    return (axis_bucket(n_scenarios, S_BUCKET_FLOOR), pad_width(max_streams),
            axis_bucket(n_designs, D_BUCKET_FLOOR), int(n_platforms))


def warmup_fold(shape: tuple[int, int, int, int], device="cuda") -> None:
    """Run the fold once at one bucketed (s, k, d, p) shape on inert dummy
    data — the same argument shapes/dtypes ``evaluate_bucketed`` passes —
    so the device's context, its kernels and the allocator's blocks for
    that shape are ready before a real request arrives."""
    device = device_mod.resolve(device)
    s, k, d, p = shape
    zeros_sk = np.zeros((s, k))
    false_sk = np.zeros((s, k), dtype=bool)
    vec = np.zeros(d)
    pmat = np.ones((p, len(PLATFORM_FIELDS)))  # ones: no 0-divides
    _run_fold(device, zeros_sk, false_sk, np.full((s, k), np.inf), false_sk,
              false_sk, np.zeros(s), vec, vec, vec, vec, vec, np.ones(d),
              pmat)


def warmup(scenario_buckets: Sequence[int] = (S_BUCKET_FLOOR, 16),
           width_buckets: Sequence[int] = (16, 1024),
           design_buckets: Sequence[int] = (D_BUCKET_FLOOR, 16),
           platform_counts: Sequence[int] = (1, 2),
           device="cuda") -> int:
    """Run the fold over a grid of common bucketed shapes (spec-independent
    warmup; the service's spec-driven warmup runs exact request shapes
    instead).  Returns the number of distinct shapes run.  The defaults
    cover small CNN/LM specs (width 16) and the wide-scenario regime
    (googlenet train packs at width 1024)."""
    shapes = {fold_shape(s, k, d, p)
              for s in scenario_buckets for k in width_buckets
              for d in design_buckets for p in platform_counts}
    for shape in sorted(shapes):
        warmup_fold(shape, device)
    return len(shapes)


def dram_tx(stats_seq: Sequence[TrafficStats],
            capacities_bytes: Sequence[float], device="cuda") -> np.ndarray:
    """[s, c] DRAM transactions at each capacity — the batched form of
    ``TrafficStats.dram_tx`` (paper Fig. 6's capacity sweep)."""
    device = device_mod.resolve(device)
    batch = pack(stats_seq)
    caps = np.array([float(c) for c in capacities_bytes], dtype=np.float64)
    out = _miss_tx(device_mod.put(batch.bytes_total, device),
                   device_mod.put(batch.reuse_distance, device),
                   device_mod.put(batch.dram_visible & batch.mask, device),
                   device_mod.put(caps, device))
    return out.cpu().numpy()


# cache_clear()/cache_info()-style hooks on the public entry points, so
# consumers can observe and reset the memoization without reaching for the
# private lru-cached implementation.
evaluate.cache_clear = _evaluate_cached.cache_clear
evaluate.cache_info = _evaluate_cached.cache_info
evaluate_platforms.cache_clear = _evaluate_cached.cache_clear
evaluate_platforms.cache_info = _evaluate_cached.cache_info


def clear_caches() -> None:
    """Drop memoized stats and tables (benchmark reruns)."""
    stats_for.cache_clear()
    _evaluate_cached.cache_clear()
