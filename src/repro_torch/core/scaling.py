"""Scalability analysis — paper §IV-C (Figs. 9, 10).

Each memory technology is EDAP-tuned independently at every capacity
(Algorithm 1), then folded through the workload model to produce mean
normalized energy / latency / EDP vs SRAM across all workloads — the
paper's projection for the GPU L2 growth trend of Fig. 1 (and, in our
hardware adaptation, for TPU-class on-chip buffer capacities).

Both sweeps are thin adapters over the unified sweep pipeline
(core/sweep.py): ppa_sweep reads tuned designs from the shared memoized
design table the spec lowers to, and workload_sweep declares a SweepSpec
whose design axis is the full (capacity x memory) grid — one circuit
evaluation plus one batched workload fold, no scalar per-combination
calls and no per-analysis fold plumbing.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections.abc import Sequence

from repro_torch.core import engine, sweep
from repro_torch.core.isocap import INFER_BATCH, TRAIN_BATCH, MEMS
from repro_torch.core.tech import Platform, GTX_1080TI
from repro_torch.core.workloads import Workload, paper_workloads

CAPACITIES_MB = (1, 2, 4, 8, 16, 32)  # paper Algorithm 1's capacity set


def tuned_table(capacities_mb: Sequence[float],
                device="cuda") -> engine.DesignTable:
    """The shared batched sweep for all technologies at these capacities."""
    return sweep.lower_designs(sweep.design_grid(MEMS, capacities_mb),
                               device=device)[0]


@dataclasses.dataclass(frozen=True)
class PPARow:
    """Fig. 9: raw PPA of the tuned design at one capacity."""

    capacity_mb: float
    mem: str
    read_latency_ns: float
    write_latency_ns: float
    read_energy_nj: float
    write_energy_nj: float
    leakage_w: float
    area_mm2: float


@dataclasses.dataclass(frozen=True)
class ScalingRow:
    """Fig. 10: workload-mean normalized metrics at one capacity."""

    capacity_mb: float
    mem: str
    training: bool
    energy_x: float      # mean E_mem / E_sram   (lower is better)
    latency_x: float
    edp_x: float
    energy_std: float
    edp_std: float


def ppa_sweep(capacities_mb: Sequence[float] = CAPACITIES_MB,
              device="cuda") -> list[PPARow]:
    table = tuned_table(capacities_mb, device)
    rows = []
    for cap in capacities_mb:
        for mem in MEMS:
            d = table.tuned(mem, int(cap * 2**20))
            rows.append(PPARow(
                capacity_mb=cap, mem=mem,
                read_latency_ns=d.read_latency_s * 1e9,
                write_latency_ns=d.write_latency_s * 1e9,
                read_energy_nj=d.read_energy_j * 1e9,
                write_energy_nj=d.write_energy_j * 1e9,
                leakage_w=d.leakage_w,
                area_mm2=d.area_mm2,
            ))
    return rows


def workload_sweep(capacities_mb: Sequence[float] = CAPACITIES_MB,
                   workloads: dict[str, Workload] | None = None,
                   platform: Platform = GTX_1080TI,
                   device="cuda") -> list[ScalingRow]:
    """One declarative sweep over the [workload x stage] x [memory x
    capacity] grid, then per-(capacity, stage, memory) reductions over the
    result tensors."""
    workloads = workloads if workloads is not None else paper_workloads()
    stages = ((False, INFER_BATCH), (True, TRAIN_BATCH))
    spec = sweep.SweepSpec(
        name="scaling",
        scenarios=sweep.workload_scenarios(workloads, stages,
                                           stage_major=True),
        designs=sweep.design_grid(MEMS, capacities_mb),
        platforms=(platform,))
    wt = sweep.run(spec, device=device).tables[0]

    energy = wt.total_j(False)   # [s, d]
    latency = wt.runtime_s
    edp = wt.edp(True)
    n_wl = len(workloads)
    rows = []
    for ci, cap in enumerate(capacities_mb):
        d_of = {m: ci * len(MEMS) + mi for mi, m in enumerate(MEMS)}
        for si, (training, batch) in enumerate(stages):
            s_ids = slice(si * n_wl, (si + 1) * n_wl)
            for mem in ("stt", "sot"):
                m, s = d_of[mem], d_of["sram"]
                ex = (energy[s_ids, m] / energy[s_ids, s]).tolist()
                lx = (latency[s_ids, m] / latency[s_ids, s]).tolist()
                ed = (edp[s_ids, m] / edp[s_ids, s]).tolist()
                rows.append(ScalingRow(
                    capacity_mb=cap, mem=mem, training=training,
                    energy_x=statistics.mean(ex),
                    latency_x=statistics.mean(lx),
                    edp_x=statistics.mean(ed),
                    energy_std=statistics.pstdev(ex),
                    edp_std=statistics.pstdev(ed),
                ))
    return rows


def headline(rows: list[ScalingRow]) -> dict[str, dict[str, float]]:
    """Paper §IV-C claims: max reductions across the capacity sweep."""
    out = {}
    for mem in ("stt", "sot"):
        sub = [r for r in rows if r.mem == mem]
        out[mem] = dict(
            energy_reduction_max=max(1 / r.energy_x for r in sub),
            latency_reduction_max=max(1 / r.latency_x for r in sub),
            edp_reduction_max=max(1 / r.edp_x for r in sub),
        )
    return out
