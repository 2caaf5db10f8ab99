"""Workload memory-traffic and runtime model — the architecture layer.

Replaces the paper's nvprof profiling (iso-capacity) and feeds the cache
simulator (iso-area).  It encodes the Caffe execution model the paper
profiles:

  conv layers   loop over the batch with a shared im2col buffer:
                per image: write col, read col + weights (GEMM), write out.
  fc layers     one batched GEMM: read weights once per batch.
  training      forward + backward per batch: backward re-reads weights
                (dgrad), saved activations and re-built col buffers (wgrad),
                writes input grads and weight grads; the optimizer reads
                weights/momentum/grads and writes weights/momentum.

Every access is tagged with a characteristic **reuse distance** (bytes of
intervening traffic before the next use of the same data), which yields the
DRAM transaction count for any cache capacity — the quantity GPGPU-Sim
provides in the paper (Fig. 6) — without a cycle-level simulator.  An exact
trace-driven simulator (core/cachesim.py) validates the analytic model on
small traces.

The runtime model is the paper's "simple model" (§III-B): transactions x
per-transaction latency/energy, with a compute-overlap factor
(Platform.mem_serialization) since GPUs overlap memory and compute.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core.cachemodel import LINE_BYTES, CacheDesign
from repro_torch.core.tech import Platform, GTX_1080TI
from repro_torch.core.workloads import Workload

INF = float("inf")

# Fraction of LLC capacity that behaves as fully-associative working space
# (conflict misses + multi-kernel interleaving under 16-way LRU);
# calibrated together with MISS_CURVE_P against the Fig. 6 anchors
# (paper: 14.6% DRAM reduction @7 MB, 19.8% @10 MB -> model 13.6%/18.5%).
ASSOC_EFFICIENCY = 0.5
# Exponent of the smooth miss-probability curve (RD/(RD+C_eff))^p.  p=2
# mimics the sharp-but-not-binary capacity transitions GPGPU-Sim shows.
MISS_CURVE_P = 2.0
# Backward-pass activation re-read multiplier (dgrad + wgrad both touch
# saved activations; Caffe also re-reads for the ReLU/pool masks).
BWD_ACT_REREADS = 2.0
# GPU compute efficiency on DL GEMMs/convs (nvprof-era Caffe on Pascal).
COMPUTE_EFFICIENCY = 0.60
# GEMM tile dims (thread-block tiles): inputs are re-read from L2 once per
# tile of the opposing dimension — the dominant source of L2 *read*
# amplification on GPUs (weights re-read per output tile, col buffer
# re-read per weight tile).  These short-distance re-reads hit in any LLC.
GEMM_TILE = 128
TILE_REUSE_RD = 256 * 1024  # reuse distance of intra-GEMM tile re-reads


@dataclasses.dataclass(frozen=True)
class AccessStream:
    """A homogeneous group of L2 accesses within one batch."""

    label: str
    bytes_total: float       # total bytes moved by this stream per batch
    is_write: bool
    reuse_distance: float    # bytes of intervening traffic until next use
                             # (INF = streaming / first touch: always misses)
    writeback: bool = True   # dirty data written back to DRAM on eviction


@dataclasses.dataclass(frozen=True)
class TrafficStats:
    """Per-batch memory statistics of one workload execution."""

    workload: str
    batch: int
    training: bool
    streams: tuple[AccessStream, ...]
    macs_per_batch: float

    # Structure-of-arrays view of the streams: the miss-curve fold runs
    # vectorized, and the per-capacity DRAM curve is memoized (the stats
    # are capacity-independent, so every cache design re-queries the same
    # few capacities).  cached_property writes the instance __dict__
    # directly, so it composes with the frozen dataclass.

    @functools.cached_property
    def _arrays(self) -> dict[str, np.ndarray]:
        return dict(
            bytes_total=np.array([s.bytes_total for s in self.streams],
                                 dtype=np.float64),
            is_write=np.array([s.is_write for s in self.streams], dtype=bool),
            reuse_distance=np.array([s.reuse_distance for s in self.streams],
                                    dtype=np.float64),
            dram_visible=np.array([not (s.is_write and not s.writeback)
                                   for s in self.streams], dtype=bool),
        )

    @functools.cached_property
    def _dram_tx_memo(self) -> dict[float, float]:
        return {}

    @functools.cached_property
    def l2_read_tx(self) -> float:
        a = self._arrays
        return float(a["bytes_total"][~a["is_write"]].sum()) / LINE_BYTES

    @functools.cached_property
    def l2_write_tx(self) -> float:
        a = self._arrays
        return float(a["bytes_total"][a["is_write"]].sum()) / LINE_BYTES

    @property
    def read_write_ratio(self) -> float:
        return self.l2_read_tx / max(1.0, self.l2_write_tx)

    def dram_tx(self, capacity_bytes: float) -> float:
        """DRAM transactions for an LLC of the given capacity.

        Each access stream misses with probability
        (RD / (RD + C_eff))^MISS_CURVE_P — a smooth capacity-miss curve
        (streaming accesses with RD=inf always miss); dirty write streams
        add write-back traffic on eviction with the same probability."""
        memo = self._dram_tx_memo
        if capacity_bytes not in memo:
            a = self._arrays
            c_eff = capacity_bytes * ASSOC_EFFICIENCY
            rd = a["reuse_distance"]
            with np.errstate(invalid="ignore"):
                miss_p = np.where(np.isinf(rd), 1.0,
                                  (rd / (rd + c_eff)) ** MISS_CURVE_P)
            tx = a["bytes_total"] / LINE_BYTES * miss_p
            memo[capacity_bytes] = float(tx[a["dram_visible"]].sum())
        return memo[capacity_bytes]


def _gemm_amp_weights(layer) -> float:
    """Times the weight matrix is re-read from L2: once per N-dim tile."""
    n = layer.hout * layer.wout if layer.kind == "conv" else 1
    return max(1.0, math.ceil(n / GEMM_TILE))


def _gemm_amp_col(layer) -> float:
    """Times the col/activation matrix is re-read: once per M-dim tile."""
    return max(1.0, math.ceil(layer.cout / GEMM_TILE))


def _conv_streams(layer, batch: int) -> list[AccessStream]:
    """Caffe/DarkNet conv: per image — im2col write/read + tiled GEMM."""
    b = float(batch)
    col = layer.im2col_bytes
    per_image_ws = col + layer.act_in_bytes + layer.act_out_bytes \
        + layer.weight_bytes
    amp_w = _gemm_amp_weights(layer)
    amp_c = _gemm_amp_col(layer)
    out: list[AccessStream] = []
    if col:
        out.append(AccessStream(f"{layer.name}.colw", b * col, True, col))
        out.append(AccessStream(f"{layer.name}.colr", b * col, False, col))
        if amp_c > 1:
            out.append(AccessStream(f"{layer.name}.colr+",
                                    b * col * (amp_c - 1), False,
                                    TILE_REUSE_RD))
    # weights: first read per image (reuse distance = one image-layer
    # working set), plus per-output-tile re-reads that hit near the MSHRs
    out.append(AccessStream(f"{layer.name}.w", b * layer.weight_bytes, False,
                            per_image_ws if batch > 1 else INF))
    if amp_w > 1:
        out.append(AccessStream(f"{layer.name}.w+",
                                b * layer.weight_bytes * (amp_w - 1), False,
                                TILE_REUSE_RD))
    out.append(AccessStream(f"{layer.name}.ain", b * layer.act_in_bytes,
                            False, col if col else layer.act_in_bytes))
    out.append(AccessStream(f"{layer.name}.aout", b * layer.act_out_bytes,
                            True, layer.act_out_bytes + col))
    return out


def _fc_streams(layer, batch: int) -> list[AccessStream]:
    """Caffe fc: batched GEMM — weights stream once per batch."""
    b = float(batch)
    return [
        AccessStream(f"{layer.name}.w", layer.weight_bytes, False, INF),
        AccessStream(f"{layer.name}.ain", b * layer.act_in_bytes, False,
                     layer.weight_bytes),
        AccessStream(f"{layer.name}.aout", b * layer.act_out_bytes, True,
                     layer.weight_bytes),
    ]


def _backward_streams(layer, batch: int) -> list[AccessStream]:
    """Backward pass for one layer (training): dgrad + wgrad + saved acts."""
    b = float(batch)
    col = layer.im2col_bytes
    dy = layer.act_out_bytes
    dx = layer.act_in_bytes
    per_image_ws = col + dx + dy + layer.weight_bytes
    w_rd = b * layer.weight_bytes if layer.kind == "conv" else layer.weight_bytes
    amp_w = _gemm_amp_weights(layer)
    # dgrad: dX = W^T dY  (weights re-read per input tile, as forward)
    out = [AccessStream(f"{layer.name}.bw.w", w_rd, False,
                        per_image_ws if layer.kind == "conv" else INF)]
    if amp_w > 1:  # same guard as forward: no zero-byte stream at amp_w == 1
        out.append(AccessStream(f"{layer.name}.bw.w+", w_rd * (amp_w - 1),
                                False, TILE_REUSE_RD))
    out += [
        AccessStream(f"{layer.name}.bw.dy", b * dy * 2.0, False, dy + col),
        AccessStream(f"{layer.name}.bw.dx", b * dx, True, dx + col),
        # wgrad: dW = dY col^T — col rebuilt from saved activations
        AccessStream(f"{layer.name}.bw.act",
                     b * dx * BWD_ACT_REREADS, False, INF),  # saved in fwd
        AccessStream(f"{layer.name}.bw.dw", layer.weight_bytes, True, INF),
    ]
    if col:
        amp_c = _gemm_amp_col(layer)
        out.append(AccessStream(f"{layer.name}.bw.colw", b * col, True, col))
        out.append(AccessStream(f"{layer.name}.bw.colr", b * col * amp_c,
                                False, col if amp_c == 1 else TILE_REUSE_RD))
    return out


def _optimizer_streams(workload: Workload) -> list[AccessStream]:
    """SGD+momentum update: read W, M, dW; write W, M (once per batch)."""
    pbytes = float(sum(l.weight_bytes for l in workload.layers))
    return [
        AccessStream("opt.read", 3.0 * pbytes, False, INF),
        AccessStream("opt.write", 2.0 * pbytes, True, INF),
    ]


def build(workload: Workload, batch: int, training: bool) -> TrafficStats:
    streams: list[AccessStream] = []
    for layer in workload.layers:
        builder = _conv_streams if layer.kind == "conv" else _fc_streams
        streams.extend(builder(layer, batch))
    macs = float(workload.total_macs) * batch
    if training:
        for layer in workload.layers:
            streams.extend(_backward_streams(layer, batch))
        streams.extend(_optimizer_streams(workload))
        macs *= 3.0  # fwd + dgrad + wgrad
    # zero-byte streams would pollute the SoA fold arrays and the padded
    # batched tensors (workload_engine) with degenerate entries
    assert all(s.bytes_total > 0 for s in streams), \
        [s.label for s in streams if s.bytes_total <= 0]
    return TrafficStats(workload.name, batch, training, tuple(streams), macs)


# ---------------------------------------------------------------------------
# Runtime / energy / EDP (paper §III-B "simple model" + platform overlap)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """One bar of paper Figs. 3/4/7/8."""

    workload: str
    mem: str
    runtime_s: float
    dyn_read_j: float
    dyn_write_j: float
    leak_j: float
    dram_j: float

    @property
    def dyn_j(self) -> float:
        return self.dyn_read_j + self.dyn_write_j

    def total_j(self, include_dram: bool = False) -> float:
        return self.dyn_j + self.leak_j + (self.dram_j if include_dram else 0.0)

    def edp(self, include_dram: bool = False) -> float:
        return self.total_j(include_dram) * self.runtime_s


def runtime(stats: TrafficStats, design: CacheDesign,
            platform: Platform = GTX_1080TI,
            include_dram: bool = True) -> float:
    t_compute = stats.macs_per_batch * 2.0 / (platform.peak_flops
                                              * COMPUTE_EFFICIENCY)
    t_l2 = (stats.l2_read_tx * design.read_latency_s
            + stats.l2_write_tx * design.write_latency_s)
    t = t_compute + platform.mem_serialization * t_l2
    if include_dram:
        dram_tx = stats.dram_tx(design.capacity_bytes)
        t += dram_tx * LINE_BYTES / platform.dram_bw
    return t


def energy(stats: TrafficStats, design: CacheDesign,
           platform: Platform = GTX_1080TI,
           include_dram: bool = True) -> EnergyReport:
    t = runtime(stats, design, platform, include_dram)
    dram_tx = stats.dram_tx(design.capacity_bytes)
    return EnergyReport(
        workload=stats.workload,
        mem=design.mem,
        runtime_s=t,
        dyn_read_j=stats.l2_read_tx * design.read_energy_j,
        dyn_write_j=stats.l2_write_tx * design.write_energy_j,
        leak_j=design.leakage_w * t,
        dram_j=dram_tx * LINE_BYTES * platform.dram_energy_per_byte,
    )
