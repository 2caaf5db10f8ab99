"""Pareto / DSE reductions over evaluated sweeps.

The multi-capacity sweeps (scaling, nvm_dse, DTCO) produce a design axis
far wider than the paper's three iso-capacity columns; this module reduces
an evaluated :class:`~repro_torch.core.sweep.SweepResult` to the decisions a DSE
flow actually wants:

  * ``pareto_front`` — per (platform, scenario), the non-dominated designs
    over a set of minimize-objectives (default energy / runtime / area:
    the EDAP axes Algorithm 1 trades off, now across the whole design
    axis rather than within one (mem, capacity) organization sweep).
  * ``capacity_plateaus`` — per (platform, scenario, mem, node), the
    capacity knee: the smallest capacity whose metric is within
    ``rel_tol`` of the best along the capacity axis.  Beyond it, more
    on-chip memory buys less than ``rel_tol`` — the Fig. 9/10 "leakage
    eats the capacity win" argument reduced to one number per memory.

Everything here is a pure reduction of the result tensors (numpy only —
no engine calls, no sweep imports; the result object is duck-typed), so
the query layer stays cycle-free below core/sweep.py.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

# Objectives are SweepResult.metric names plus "area" (a design attribute,
# broadcast over platforms and scenarios).  All are minimized.
DEFAULT_OBJECTIVES = ("energy", "runtime", "area")


def objective_tensor(result, name: str,
                     include_dram: bool = False) -> np.ndarray:
    """[p, s, d] tensor of one objective (metrics via the result's metric
    vocabulary; "area" from the tuned designs)."""
    if name == "area":
        area = np.array([d.area_mm2 for d in result.designs],
                        dtype=np.float64)
        shape = (len(result.platform_labels), len(result.scenario_labels),
                 area.size)
        return np.broadcast_to(area, shape)
    return result.metric(name, include_dram)


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """[n] mask of the non-dominated rows of an [n, k] objective matrix
    (minimization; a point is dominated when some other point is <= on
    every objective and < on at least one)."""
    pts = np.asarray(points, dtype=np.float64)
    le = (pts[:, None, :] <= pts[None, :, :]).all(axis=2)   # [i, j]: i <= j
    lt = (pts[:, None, :] < pts[None, :, :]).any(axis=2)
    dominated = (le & lt).any(axis=0)                       # some i beats j
    return ~dominated


def pareto_front(result, objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                 include_dram: bool = False) -> list[dict]:
    """Non-dominated designs per (platform, scenario) cell, as tidy rows
    (axis labels + the objective values + the cell's front size)."""
    objectives = tuple(objectives)
    tensors = [objective_tensor(result, o, include_dram) for o in objectives]
    rows = []
    for pi, platform in enumerate(result.platform_labels):
        for si in range(len(result.scenario_labels)):
            pts = np.stack([t[pi, si, :] for t in tensors], axis=1)
            mask = pareto_mask(pts)
            front = np.flatnonzero(mask)
            for di in front:
                rows.append(dict(platform=platform,
                                 **result.scenario_attrs(si),
                                 **result.design_attrs(int(di)),
                                 design_index=int(di),
                                 front_size=int(front.size),
                                 **{o: float(pts[di, k])
                                    for k, o in enumerate(objectives)}))
    return rows


def capacity_plateaus(result, metric: str = "edp",
                      include_dram: bool = True,
                      rel_tol: float = 0.05) -> list[dict]:
    """Capacity-plateau detection along the design axis.

    For every (mem, node) that appears at two or more capacities, and for
    every (platform, scenario): sort the capacities, find the best metric
    value along the axis, and report the smallest capacity within
    ``rel_tol`` of it.  ``plateau_penalty`` is the relative distance of
    the plateau point from the best (0 when the plateau IS the best)."""
    t = objective_tensor(result, metric, include_dram)
    by_mem_node: dict[tuple[str, str], list[tuple[float, int]]] = {}
    for j, p in enumerate(result.spec.designs):
        by_mem_node.setdefault((p.mem, p.node.name), []).append(
            (p.capacity_mb, j))
    rows = []
    for (mem, node), caps in by_mem_node.items():
        if len(caps) < 2:
            continue
        caps = sorted(caps)
        cap_axis = [c for c, _ in caps]
        ids = [j for _, j in caps]
        for pi, platform in enumerate(result.platform_labels):
            for si in range(len(result.scenario_labels)):
                v = t[pi, si, ids]
                best_i = int(v.argmin())
                within = np.flatnonzero(v <= v[best_i] * (1.0 + rel_tol))
                plateau_i = int(within[0])
                rows.append(dict(platform=platform,
                                 **result.scenario_attrs(si),
                                 mem=mem, node=node,
                                 plateau_capacity_mb=cap_axis[plateau_i],
                                 best_capacity_mb=cap_axis[best_i],
                                 plateau_penalty=float(
                                     v[plateau_i] / v[best_i] - 1.0)))
    return rows
