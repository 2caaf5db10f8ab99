"""Iso-area analysis — paper §III-D / §IV-B (Figs. 6, 7, 8).

The NVM density advantage is spent on capacity: the MRAM cache that fits
the 3 MB SRAM area budget (7 MB STT / 10 MB SOT, from the tuner's area
model).  The larger capacity reduces DRAM traffic (Fig. 6 — GPGPU-Sim in
the paper, the reuse-distance model here), which is where iso-area MRAM
wins: slower, bigger caches, but far fewer costly off-chip accesses.

Both Fig. 6 and Figs. 7/8 are thin SweepSpec adapters (core/sweep.py):
the DRAM curve reads the platform-independent [scenario] x [capacity]
DRAM-transaction tensor of a capacity-axis sweep, and the energy/EDP rows
come from a sweep over the iso-area design corners.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from repro_torch.core import sweep, tuner
from repro_torch.core.isocap import (INFER_BATCH, TRAIN_BATCH, IsoCapRow,
                               rows_from_result)
from repro_torch.core.tech import Platform, GTX_1080TI, TechNode, TECH_16NM
from repro_torch.core.workloads import Workload, paper_workloads, alexnet


@dataclasses.dataclass(frozen=True)
class IsoAreaDesigns:
    sram: object
    stt: object
    sot: object
    stt_capacity_mb: int
    sot_capacity_mb: int

    def as_dict(self):
        return {"sram": self.sram, "stt": self.stt, "sot": self.sot}


def corners(sram_capacity_mb: float = 3.0,
            node: TechNode = TECH_16NM,
            device="cuda") -> tuple[sweep.DesignPoint, ...]:
    """The iso-area design corners the area budget selects: SRAM at its
    own capacity, each MRAM flavor at the largest capacity fitting the
    SRAM area (one normalization group — the SRAM baseline).  ``node``
    runs the whole selection at another technology node: the area budget
    (and so the MRAM capacities) is re-derived from that node's designs —
    the per-node iso-area study."""
    return sweep.design_corners(
        (("sram", sram_capacity_mb),
         ("stt", tuner.iso_area_capacity("stt", sram_capacity_mb,
                                         node=node, device=device)),
         ("sot", tuner.iso_area_capacity("sot", sram_capacity_mb,
                                         node=node, device=device))),
        nodes=(node,))


def designs(sram_capacity_mb: float = 3.0,
            node: TechNode = TECH_16NM, device="cuda") -> IsoAreaDesigns:
    """Iso-area design set, read from one shared batched sweep over the
    three (technology, capacity) corners the area budget selects."""
    points = corners(sram_capacity_mb, node, device)
    _, (sram_d, stt_d, sot_d) = sweep.lower_designs(points, device=device)
    return IsoAreaDesigns(
        sram=sram_d, stt=stt_d, sot=sot_d,
        stt_capacity_mb=int(points[1].capacity_mb),
        sot_capacity_mb=int(points[2].capacity_mb),
    )


def dram_reduction_curve(workload: Workload | None = None, batch: int = INFER_BATCH,
                         training: bool = False,
                         capacities_mb: Sequence[float] = (3, 6, 7, 10, 12, 24),
                         device="cuda") -> dict[float, float]:
    """Fig. 6: % reduction in DRAM accesses vs the 3 MB baseline as the
    last-level cache grows (paper: AlexNet via GPGPU-Sim/DarkNet).  The
    capacity axis is the design axis of a sweep; the curve reads its
    platform-independent DRAM-transaction tensor."""
    w = workload if workload is not None else alexnet()
    caps = (3,) + tuple(capacities_mb)
    spec = sweep.SweepSpec(
        name="isoarea-dram",
        scenarios=sweep.workload_scenarios((w,), ((training, batch),)),
        designs=tuple(sweep.DesignPoint("sram", int(c * 2**20), group=i)
                      for i, c in enumerate(caps)))
    tx = sweep.run(spec, device=device).dram_tx[0]
    return {c: 100.0 * (1.0 - float(tx[1 + i] / tx[0]))
            for i, c in enumerate(capacities_mb)}


def analyze(workloads: dict[str, Workload] | None = None,
            platform: Platform = GTX_1080TI,
            infer_batch: int = INFER_BATCH,
            train_batch: int = TRAIN_BATCH,
            node: TechNode = TECH_16NM, device="cuda") -> list[IsoCapRow]:
    """Figs. 7/8: energy and EDP at iso-area (with/without DRAM terms) —
    one declarative sweep at the iso-area corners (of ``node``, for the
    per-node iso-area study)."""
    workloads = workloads if workloads is not None else paper_workloads()
    spec = sweep.SweepSpec(
        name="isoarea" if node == TECH_16NM else f"isoarea@{node.name}",
        scenarios=sweep.workload_scenarios(
            workloads, ((False, infer_batch), (True, train_batch))),
        designs=corners(node=node, device=device),
        platforms=(platform,))
    return rows_from_result(sweep.run(spec, device=device))


def summary(rows: list[IsoCapRow]) -> dict[str, dict[str, float]]:
    out: dict[str, dict[str, float]] = {}
    n = len(rows)
    for mem in ("stt", "sot"):
        out[mem] = dict(
            dyn_energy_x=sum(r.norm("dyn", mem) for r in rows) / n,
            leak_reduction=sum(1 / r.norm("leak", mem) for r in rows) / n,
            energy_reduction=sum(1 / r.norm("energy", mem) for r in rows) / n,
            edp_reduction_no_dram=sum(1 / r.norm("edp", mem, False)
                                      for r in rows) / n,
            edp_reduction_with_dram=sum(1 / r.norm("edp", mem, True)
                                        for r in rows) / n,
        )
    return out
