"""Cross-node DTCO analysis — the paper's framework claim taken across
technology nodes.

DeepNVM++'s pitch is that one cross-layer stack characterizes any NVM
technology at any node; Mishty & Sadi (2023) run exactly such a
design-technology co-optimization (DTCO) study for SOT-MRAM, one node at a
time, by hand.  With the technology node a first-class batched axis the
whole cross-node study is one declarative sweep: every (node x memory)
EDAP-tuned design at a fixed (iso-capacity) last-level cache size, folded
through the paper workloads in a single circuit-engine call plus a single
workload-engine call.

Each node is its own normalization group — a 7 nm STT cache is compared
against the 7 nm SRAM baseline, never the 16 nm one — which is the
per-node comparison the DTCO papers make.  The headline trend is the
paper's Fig. 9 argument projected across nodes: the 6T SRAM cell's leakage
worsens as the node shrinks (tech.SCALING_EXPONENTS) while the MRAM
flavors' storage cells do not leak, so the leakage (and with it EDP) gap
widens monotonically from 16 nm down to 7 nm.

Node parameters at non-anchor nodes are first-order Dennard-style
projections from the calibrated 16 nm anchor: every layer re-derives from
the node — the MTJ device (``mtj.device``), the bitcell fin sweep
(``bitcell.characterize``), the periphery timing/energy building blocks
(``cachemodel.periphery``), and the calibration coefficients
(``calibration.get``) — each through one documented exponent
(tech.*_SCALING_EXPONENTS), so the cross-node rows carry genuine
device-and-periphery signal, not anchor constants in disguise.

Two cross-node studies live here: the iso-capacity study (``analyze``,
every node at the same 3 MB) and the iso-AREA study (``isoarea_analyze``)
— at each node the SRAM area budget is re-derived and spent on the MRAM
capacity that fits it (``isoarea.corners(node=...)``), the deliverable the
node-aware projection layer unlocks.

Both studies run on the ``device`` their entry points take (``cuda``
unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from repro_torch.core import isoarea, sweep
from repro_torch.core.isocap import CAPACITY_MB, INFER_BATCH, TRAIN_BATCH, MEMS
from repro_torch.core.tech import (GTX_1080TI, Platform, TechNode,
                             TECH_16NM, TECH_12NM, TECH_10NM, TECH_7NM)
from repro_torch.core.workloads import Workload, paper_workloads

# The DTCO node axis: the calibrated anchor plus the scaled projections.
NODES = (TECH_16NM, TECH_12NM, TECH_10NM, TECH_7NM)


@dataclasses.dataclass(frozen=True)
class DTCORow:
    """One (node, memory) column of the cross-node iso-capacity study."""

    node: str
    feature_nm: float
    mem: str
    capacity_mb: float
    leakage_w: float     # tuned-design leakage power (circuit layer)
    area_mm2: float
    # Workload-mean metrics normalized to the same-node SRAM baseline.
    energy_x: float
    leak_x: float
    edp_x: float
    runtime_x: float


def spec(workloads: dict[str, Workload] | None = None,
         capacity_mb: float = CAPACITY_MB,
         nodes: Sequence[TechNode] = NODES,
         platform: Platform = GTX_1080TI,
         infer_batch: int = INFER_BATCH,
         train_batch: int = TRAIN_BATCH) -> sweep.SweepSpec:
    """The cross-node study as one declarative sweep: (workload x stage)
    scenarios x (node x memory) iso-capacity designs."""
    workloads = workloads if workloads is not None else paper_workloads()
    return sweep.SweepSpec(
        name="dtco",
        scenarios=sweep.workload_scenarios(
            workloads, ((False, infer_batch), (True, train_batch))),
        designs=sweep.design_grid(MEMS, (capacity_mb,), nodes=nodes),
        platforms=(platform,))


def analyze(workloads: dict[str, Workload] | None = None,
            capacity_mb: float = CAPACITY_MB,
            nodes: Sequence[TechNode] = NODES,
            platform: Platform = GTX_1080TI,
            infer_batch: int = INFER_BATCH,
            train_batch: int = TRAIN_BATCH,
            device="cuda") -> list[DTCORow]:
    """One DTCORow per (node, memory): circuit-layer leakage/area of the
    tuned design plus scenario-mean normalized workload metrics."""
    s = spec(workloads, capacity_mb, nodes, platform,
             infer_batch, train_batch)
    return _rows(s, device)


def _rows(s: sweep.SweepSpec, device="cuda") -> list[DTCORow]:
    """Run a cross-node spec on ``device`` and fold it to one DTCORow per
    design point: circuit-layer leakage/area of the tuned design plus
    scenario-mean normalized workload metrics (each node against its own
    baseline)."""
    res = sweep.run(s, device=device)
    norm = res.norm_to()
    m = {name: norm.metric(name, include_dram=(name == "edp"))
         for name in ("energy", "leak", "edp", "runtime")}
    rows = []
    for j, p in enumerate(s.designs):
        d = res.designs[j]
        rows.append(DTCORow(
            node=p.node.name,
            feature_nm=p.node.feature_size_m * 1e9,
            mem=p.mem,
            capacity_mb=p.capacity_mb,
            leakage_w=d.leakage_w,
            area_mm2=d.area_mm2,
            energy_x=float(m["energy"][0, :, j].mean()),
            leak_x=float(m["leak"][0, :, j].mean()),
            edp_x=float(m["edp"][0, :, j].mean()),
            runtime_x=float(m["runtime"][0, :, j].mean()),
        ))
    return rows


# ---------------------------------------------------------------------------
# Cross-node iso-AREA study
# ---------------------------------------------------------------------------


def isoarea_spec(workloads: dict[str, Workload] | None = None,
                 sram_capacity_mb: float = CAPACITY_MB,
                 nodes: Sequence[TechNode] = NODES,
                 platform: Platform = GTX_1080TI,
                 infer_batch: int = INFER_BATCH,
                 train_batch: int = TRAIN_BATCH,
                 device="cuda") -> sweep.SweepSpec:
    """The cross-node iso-AREA study as one declarative sweep.

    At every node the SRAM area budget is re-derived from that node's
    EDAP-tuned designs and spent on the largest-fitting MRAM capacities
    (``isoarea.corners(node=...)``) — so both the capacities *and* the
    normalization baseline are per node.  Each node's three corners share
    the ``(node.name, 0)`` normalization group, matching the node-suffixed
    ``DesignCorners`` symbolic form.  The area budgets are the design
    tables of ``device``."""
    workloads = workloads if workloads is not None else paper_workloads()
    nodes = tuple(nodes)
    points = tuple(
        dataclasses.replace(
            p, group=(nd.name, 0) if len(nodes) > 1 else 0)
        for nd in nodes
        for p in isoarea.corners(sram_capacity_mb, node=nd,
                                  device=device))
    return sweep.SweepSpec(
        name="dtco_isoarea",
        scenarios=sweep.workload_scenarios(
            workloads, ((False, infer_batch), (True, train_batch))),
        designs=points,
        platforms=(platform,))


def isoarea_analyze(workloads: dict[str, Workload] | None = None,
                    sram_capacity_mb: float = CAPACITY_MB,
                    nodes: Sequence[TechNode] = NODES,
                    platform: Platform = GTX_1080TI,
                    infer_batch: int = INFER_BATCH,
                    train_batch: int = TRAIN_BATCH,
                    device="cuda") -> list[DTCORow]:
    """One DTCORow per (node, memory) at that node's iso-area corners:
    the ``capacity_mb`` column carries the per-node iso-area capacity."""
    return _rows(isoarea_spec(workloads, sram_capacity_mb, nodes, platform,
                              infer_batch, train_batch, device), device)


def isoarea_headline(rows: Sequence[DTCORow],
                     ) -> dict[str, dict[str, float]]:
    """Cross-node iso-area trend claims: each MRAM flavor's iso-area
    capacity at both ends of the node sweep (the density advantage the
    area budget buys) and its leakage/EDP reduction there (the widening
    gap against same-node SRAM)."""
    by = {(r.node, r.mem): r for r in rows}
    node_order = list(dict.fromkeys(r.node for r in rows))
    first, last = node_order[0], node_order[-1]
    out: dict[str, dict[str, float]] = {
        "sram": dict(
            leak_w_first=by[first, "sram"].leakage_w,
            leak_w_last=by[last, "sram"].leakage_w,
            leak_growth=by[last, "sram"].leakage_w
            / by[first, "sram"].leakage_w,
        )}
    for mem in ("stt", "sot"):
        out[mem] = dict(
            capacity_mb_first=by[first, mem].capacity_mb,
            capacity_mb_last=by[last, mem].capacity_mb,
            leak_reduction_first=1.0 / by[first, mem].leak_x,
            leak_reduction_last=1.0 / by[last, mem].leak_x,
            edp_reduction_first=1.0 / by[first, mem].edp_x,
            edp_reduction_last=1.0 / by[last, mem].edp_x,
        )
    return out


def headline(rows: Sequence[DTCORow]) -> dict[str, dict[str, float]]:
    """Cross-node trend claims: SRAM leakage growth from the first to the
    last node of the sweep, and each MRAM flavor's leakage/EDP reduction at
    both ends (the widening-gap argument)."""
    by = {(r.node, r.mem): r for r in rows}
    node_order = list(dict.fromkeys(r.node for r in rows))
    first, last = node_order[0], node_order[-1]
    out: dict[str, dict[str, float]] = {
        "sram": dict(
            leak_w_first=by[first, "sram"].leakage_w,
            leak_w_last=by[last, "sram"].leakage_w,
            leak_growth=by[last, "sram"].leakage_w
            / by[first, "sram"].leakage_w,
        )}
    for mem in ("stt", "sot"):
        out[mem] = dict(
            leak_reduction_first=1.0 / by[first, mem].leak_x,
            leak_reduction_last=1.0 / by[last, mem].leak_x,
            edp_reduction_first=1.0 / by[first, mem].edp_x,
            edp_reduction_last=1.0 / by[last, mem].edp_x,
        )
    return out
