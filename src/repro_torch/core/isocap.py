"""Iso-capacity analysis — paper §III-C / §IV-A (Figs. 3, 4, 5).

Same cache capacity (3 MB) for SRAM, STT-MRAM, SOT-MRAM; workload memory
statistics from the traffic model; outputs normalized dynamic/leakage
energy breakdowns, total energy, and EDP per workload for inference
(batch 4) and training (batch 64), plus the batch-size sweep of Fig. 5.

Both analyses are thin adapters over the unified sweep pipeline
(core/sweep.py): they declare a SweepSpec (scenarios x designs x
platform) and materialize IsoCapRows from the one batched evaluation it
lowers to — no per-analysis designs/fold plumbing.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from repro_torch.core import sweep
from repro_torch.core.sweep import MEMS  # noqa: F401  (re-export: analyses' axis)
from repro_torch.core.tech import Platform, GTX_1080TI
from repro_torch.core.traffic import EnergyReport
from repro_torch.core.workloads import Workload, paper_workloads

INFER_BATCH = 4
TRAIN_BATCH = 64
CAPACITY_MB = 3


def designs_at(capacity_mb: float, device="cuda") -> dict[str, object]:
    """EDAP-tuned designs for all technologies at one capacity, read from
    the shared memoized batched sweep (one engine evaluation)."""
    _, designs = sweep.lower_designs(sweep.design_grid(MEMS, (capacity_mb,)),
                                     device=device)
    return dict(zip(MEMS, designs))


@dataclasses.dataclass(frozen=True)
class IsoCapRow:
    """One (workload, stage) row across all memories."""

    workload: str
    training: bool
    batch: int
    reports: dict[str, EnergyReport]
    read_write_ratio: float

    def norm(self, metric: str, mem: str, include_dram: bool = False) -> float:
        """Value for `mem` normalized to SRAM (paper figure convention)."""
        get = {
            "dyn": lambda r: r.dyn_j,
            "leak": lambda r: r.leak_j,
            "energy": lambda r: r.total_j(include_dram),
            "edp": lambda r: r.edp(include_dram),
            "runtime": lambda r: r.runtime_s,
        }[metric]
        return get(self.reports[mem]) / get(self.reports["sram"])


def rows_from_result(result: sweep.SweepResult,
                     platform_index: int = 0) -> list[IsoCapRow]:
    """Materialize one IsoCapRow per scenario from a sweep result (used by
    every memory-unique-design analysis: isocap, isoarea, Fig. 5)."""
    table = result.tables[platform_index]
    ratios = table.read_write_ratio
    return [IsoCapRow(workload, training, batch, table.reports(i),
                      float(ratios[i]))
            for i, (workload, batch, training) in enumerate(table.scenarios)]


def spec(workloads: dict[str, Workload] | None = None,
         capacity_mb: float = CAPACITY_MB,
         platform: Platform = GTX_1080TI,
         infer_batch: int = INFER_BATCH,
         train_batch: int = TRAIN_BATCH) -> sweep.SweepSpec:
    """The Figs. 3/4 study as one declarative sweep (the spec the golden
    ``specs/isocap.json`` document resolves to)."""
    workloads = workloads if workloads is not None else paper_workloads()
    return sweep.SweepSpec(
        name="isocap",
        scenarios=sweep.workload_scenarios(
            workloads, ((False, infer_batch), (True, train_batch))),
        designs=sweep.design_grid(MEMS, (capacity_mb,)),
        platforms=(platform,))


def analyze(workloads: dict[str, Workload] | None = None,
            capacity_mb: float = CAPACITY_MB,
            platform: Platform = GTX_1080TI,
            infer_batch: int = INFER_BATCH,
            train_batch: int = TRAIN_BATCH,
            device="cuda") -> list[IsoCapRow]:
    """Figs. 3/4: per workload x {inference, training} x memory — one
    declarative sweep over the iso-capacity design grid."""
    return rows_from_result(sweep.run(spec(
        workloads, capacity_mb, platform, infer_batch, train_batch),
        device=device))


def batch_sweep(workload: Workload, training: bool,
                batches: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                capacity_mb: float = CAPACITY_MB,
                platform: Platform = GTX_1080TI,
                device="cuda") -> list[IsoCapRow]:
    """Fig. 5: EDP vs batch size (paper: AlexNet, 3 MB iso-capacity) — the
    batch axis is the scenario dimension of the sweep."""
    spec = sweep.SweepSpec(
        name="isocap-batch",
        scenarios=sweep.workload_scenarios(
            (workload,), tuple((training, b) for b in batches)),
        designs=sweep.design_grid(MEMS, (capacity_mb,)),
        platforms=(platform,))
    return rows_from_result(sweep.run(spec, device=device))


def summary(rows: list[IsoCapRow]) -> dict[str, dict[str, float]]:
    """Aggregates matching the paper's §IV-A prose claims."""
    out: dict[str, dict[str, float]] = {}
    n = len(rows)
    for mem in ("stt", "sot"):
        out[mem] = dict(
            dyn_energy_x=sum(r.norm("dyn", mem) for r in rows) / n,
            leak_reduction=sum(1 / r.norm("leak", mem) for r in rows) / n,
            energy_reduction=sum(1 / r.norm("energy", mem) for r in rows) / n,
            edp_reduction_mean=sum(1 / r.norm("edp", mem, True) for r in rows) / n,
            edp_reduction_max=max(1 / r.norm("edp", mem, True) for r in rows),
        )
    sram_read_share = [
        r.reports["sram"].dyn_read_j / r.reports["sram"].dyn_j for r in rows]
    out["sram"] = dict(read_share_of_dyn=sum(sram_read_share) / n)
    return out
