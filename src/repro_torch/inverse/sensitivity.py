"""Elasticity tables: d ln(metric) / d ln(leaf) per (node, tech, scenario).

The sensitivity layer answers the paper-level question "which device
knob buys the most EDP at each node" with one forward-mode Jacobian of
the relaxed pipeline (``torch.func.jacfwd``).  Because theta is ln(leaf)
space and the map is ``Lowered.scenario_objective`` (ln objective at
fixed per-point winner orgs), the raw Jacobian entries *are*
elasticities: a value of -0.7 for ``tau_set_s`` means a 1% faster set
pulse buys 0.7% EDP at that (node, tech, scenario) — directly comparable
across leaves of wildly different units and magnitudes.

Orgs are pinned at each design point's own grid-argmin winner (the
organization Algorithm 1 would pick), so the tables describe the
sensitivity of *tuned* designs, not of an arbitrary organization.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import scenarios as scenarios_mod
from repro_torch.core import device as device_mod
from repro_torch.inverse.bounds import LEAF_FIELDS, N_LEAVES
from repro_torch.inverse.problem import InverseProblem
from repro_torch.inverse.relax import Lowered, lowered_on


def winner_orgs(lowered: Lowered) -> tuple[int, ...]:
    """Each design point's grid-argmin organization index (the org the
    standard tuned sweep would select for that corner)."""
    obj, _ = lowered.grid_objective()
    masked = np.where(lowered.valid_host, obj, np.inf)
    return tuple(int(i) for i in np.argmin(masked, axis=1))


def sensitivity_rows(problem: InverseProblem,
                     lowered: Lowered | None = None,
                     theta: np.ndarray | None = None,
                     device="cuda") -> list[dict]:
    """Flat elasticity table at ``theta`` (default: the anchor centers),
    computed on ``device``.

    One row per (platform, scenario, NVM design point, leaf):
    ``{"node", "mem", "capacity_mb", "platform", "scenario", "leaf",
    "elasticity", "center"}`` where ``elasticity`` is
    d ln(objective) / d ln(leaf).  For the "edap" objective the
    platform/scenario columns are None (EDAP has no workload axis).
    """
    lowered = lowered_on(problem, lowered, device)
    theta = lowered.theta0 if theta is None else np.asarray(theta)
    org_idx = winner_orgs(lowered)
    jac = torch.func.jacfwd(
        lambda th: lowered.scenario_objective(th, org_idx))(
        device_mod.put(theta, lowered.device)).cpu().numpy()  # [p, s, k, T]

    spec = problem.sweep.resolve()
    if problem.objective == "edap":
        plat_names: tuple[str | None, ...] = (None,)
        scen_names: tuple[str | None, ...] = (None,)
    else:
        plat_names = tuple(p.name for p in spec.platforms)
        scen_names = tuple(scenarios_mod.name_of(s)
                           for s in spec.scenarios)

    nk, mk = lowered.nk.tolist(), lowered.mk.tolist()
    rows = []
    for ki, point in enumerate(lowered.points):
        key = (nk[ki], mk[ki])
        if key not in lowered.relaxed:
            continue                   # sram corner: no leaves
        g = lowered.groups[lowered.relaxed[key]]
        for pi, plat in enumerate(plat_names):
            for si, scen in enumerate(scen_names):
                for li, leaf in enumerate(LEAF_FIELDS):
                    rows.append({
                        "node": point.node.name,
                        "mem": point.mem,
                        "capacity_mb": point.capacity_mb,
                        "platform": plat,
                        "scenario": scen,
                        "leaf": leaf,
                        "elasticity": float(
                            jac[pi, si, ki, g.offset + li]),
                        "center": g.centers[li],
                    })
    return rows


def top_knobs(rows: list[dict], n: int = 1) -> list[dict]:
    """The ``n`` largest |elasticity| leaves per (node, mem), averaged
    over platforms and scenarios — the headline "which knob buys the
    most" ranking."""
    acc: dict[tuple[str, str, str], list[float]] = {}
    centers: dict[tuple[str, str, str], float] = {}
    for r in rows:
        key = (r["node"], r["mem"], r["leaf"])
        acc.setdefault(key, []).append(r["elasticity"])
        centers[key] = r["center"]
    out = []
    by_design: dict[tuple[str, str], list[tuple[str, float]]] = {}
    for (node, mem, leaf), vals in acc.items():
        by_design.setdefault((node, mem), []).append(
            (leaf, float(np.mean(vals))))
    for (node, mem), leaves in sorted(by_design.items()):
        for leaf, mean_el in sorted(leaves,
                                    key=lambda t: -abs(t[1]))[:n]:
            out.append({"node": node, "mem": mem, "leaf": leaf,
                        "mean_elasticity": mean_el,
                        "center": centers[(node, mem, leaf)]})
    return out


__all__ = ["sensitivity_rows", "top_knobs", "winner_orgs", "LEAF_FIELDS",
           "N_LEAVES"]
