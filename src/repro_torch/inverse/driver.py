"""Multi-start projected-Adam driver + standard-path verification.

``solve`` runs batched gradient descent on a :class:`~repro_torch.
inverse.relax.Lowered` problem: starts are a [S, T] theta batch (start 0
at the anchor centers, the rest uniform in the ln-bounds box), each
start runs ``iters`` projected-Adam steps under a geometric temperature
schedule (a loop over the temperatures), and each step is one
``torch.func.vmap`` of ``torch.func.grad_and_value`` over a chunk of
starts — wide start grids evaluate as one batched computation per step,
chunked like the sharded sweep lowering so an S=512 grid does not
materialize at once.  The per-step losses stay on the device and come
home once per chunk.

Hardening is explicit, not asymptotic: every converged start is
re-evaluated at :data:`~repro_torch.inverse.relax.HARD_TEMP` (where the
softmins are exactly one-hot), the winning (corner, org) cell is an
argmin over the hardened objective matrix restricted to the area
budget, and ``verify`` re-builds that exact design through the
*standard* non-relaxed path — ``mtj.custom_device`` ->
``bitcell.assemble`` -> ``engine.evaluate`` ->
``workload_engine.evaluate_platforms`` — and reports the measured
relative parity.  The result therefore never rests on the relaxation:
every number in an :class:`InverseResult` is backed by the same code
path the paper-reproduction sweeps use.

Every entry point runs on ``device`` (``cuda`` unless the caller passes
``"cpu"``; it raises without CUDA).  A ``lowered`` passed in must have
been lowered on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitcell as bitcell_mod
from repro_torch.core import calibration, engine, mtj, workload_engine
from repro_torch.core import device as device_mod
from repro_torch.core.cachemodel import CacheDesign
from repro_torch.inverse import relax
from repro_torch.inverse.problem import InverseProblem, InverseResult
from repro_torch.inverse.relax import HARD_TEMP, Lowered

# Adam moments; lr comes from the problem.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# Starts evaluated per vmapped step (mirrors the sharded sweep's
# chunking: wide start grids stream through fixed-size batches).
START_CHUNK = 16


def _temps(problem: InverseProblem) -> np.ndarray:
    """Geometric annealing schedule temp_hi -> temp_lo over the iters."""
    return np.geomspace(problem.temp_hi, problem.temp_lo, problem.iters)


def _theta_starts(lowered: Lowered) -> np.ndarray:
    """[S, T] start batch: centers first, then uniform in the box."""
    problem = lowered.problem
    rng = np.random.default_rng(problem.seed)
    rows = [lowered.theta0]
    for _ in range(problem.starts - 1):
        rows.append(rng.uniform(lowered.theta_lo, lowered.theta_hi))
    return np.stack(rows)


def _solve_starts(lowered: Lowered, theta0s: np.ndarray,
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Projected Adam on every start: ([S, T] thetas, [S, iters] losses)."""
    problem = lowered.problem
    temps = [float(t) for t in _temps(problem)]
    lo_b = device_mod.put(lowered.theta_lo, lowered.device)
    hi_b = device_mod.put(lowered.theta_hi, lowered.device)
    lr = problem.lr
    grad_and_value = torch.func.vmap(torch.func.grad_and_value(lowered.loss),
                                     in_dims=(0, None))
    thetas, losses = [], []
    for i in range(0, len(theta0s), START_CHUNK):
        theta = device_mod.put(theta0s[i:i + START_CHUNK], lowered.device)
        m = torch.zeros_like(theta)
        v = torch.zeros_like(theta)
        t = 0.0
        chunk_losses = []
        for temp in temps:
            g, loss = grad_and_value(theta, temp)
            t = t + 1.0
            m = _B1 * m + (1.0 - _B1) * g
            v = _B2 * v + (1.0 - _B2) * g * g
            m_hat = m / (1.0 - _B1 ** t)
            v_hat = v / (1.0 - _B2 ** t)
            theta = theta - lr * m_hat / (torch.sqrt(v_hat) + _EPS)
            theta = torch.clamp(theta, lo_b, hi_b)
            chunk_losses.append(loss)
        thetas.append(theta.cpu().numpy())
        losses.append(torch.stack(chunk_losses, dim=1).cpu().numpy())
    return np.concatenate(thetas), np.concatenate(losses)


def grid_argmin(problem: InverseProblem, lowered: Lowered | None = None,
                device="cuda") -> dict:
    """The Algorithm-1-style reference: argmin of the problem objective
    over the grid corners x orgs through the standard memoized engine
    path, restricted to the area budget."""
    lowered = relax.lowered_on(problem, lowered, device)
    obj, area = lowered.grid_objective()
    ki, oi = lowered.masked_argmin(obj, area)
    return {"point": ki, "org": oi, "value": float(obj[ki, oi]),
            "area_mm2": float(area[ki]),
            "corner": lowered.corner_info(ki, oi),
            "objective_matrix": obj, "areas_mm2": area}


def _harden(lowered: Lowered, theta) -> tuple[np.ndarray, np.ndarray]:
    """([k, o] objective, [k] area) at ``theta`` and HARD_TEMP, on the
    host."""
    obj, area, _ = lowered.objective_matrix(
        device_mod.put(np.asarray(theta), lowered.device), HARD_TEMP)
    return obj.cpu().numpy(), area.cpu().numpy()


def recover_corner(problem: InverseProblem, lowered: Lowered | None = None,
                   device="cuda") -> dict:
    """The relaxed pipeline hardened at the anchor centers: with leaves
    pinned and the softmins at :data:`HARD_TEMP`, the selected (corner,
    org) must recover :func:`grid_argmin`'s winner — the softmin ->
    argmin consistency check."""
    lowered = relax.lowered_on(problem, lowered, device)
    obj, area = _harden(lowered, lowered.theta0)
    ki, oi = lowered.masked_argmin(obj, area)
    return {"point": ki, "org": oi, "value": float(obj[ki, oi]),
            "area_mm2": float(area[ki]),
            "corner": lowered.corner_info(ki, oi),
            "objective_matrix": obj}


def _standard_cell(lowered: Lowered, theta: np.ndarray, ki: int):
    """The winning point's bitcell through the standard path: a custom
    device with the converged leaves, assembled over the fin grid with
    ``characterize``'s own min-EDAP rule."""
    p = lowered.points[ki]
    if p.mem == "sram":
        return bitcell_mod.characterize("sram", p.node)
    gi = lowered.relaxed[(int(lowered.nk[ki]), int(lowered.mk[ki]))]
    group = lowered.groups[gi]
    leaves = group.leaves(theta)
    dev = mtj.custom_device(p.mem, p.node, **group.device_overrides(theta))
    cells = [c for fr, fw, shared in bitcell_mod.fin_assignments(p.mem)
             if (c := bitcell_mod.assemble(
                 p.mem, p.node, fr, fw, shared, device=dev,
                 area_base_norm=leaves["area_base_norm"])) is not None]
    if not cells:
        raise ValueError(f"converged {p.mem} leaves are write-infeasible "
                         f"at {p.node.name} (the scaling-wall penalty "
                         "should have prevented this)")
    return min(cells, key=bitcell_mod._edap)


def verify(lowered: Lowered, theta: np.ndarray, ki: int, oi: int) -> dict:
    """Re-evaluate one converged (theta, corner, org) point through the
    standard (non-relaxed) pipeline on the lowering's device and report
    the objective value, the materialized :class:`CacheDesign`, and the
    per-field PPA values."""
    device = lowered.device
    p = lowered.points[ki]
    cell = _standard_cell(lowered, theta, ki)
    cal = calibration.get(p.mem, p.node, device=device)
    out = engine.evaluate(
        (p.capacity_bytes,), (engine.ORGS[oi],), mems=(p.mem,),
        cells=((cell,),), cals=((cal,),), nodes=p.node, device=device)
    ppa = {k: float(np.asarray(v).reshape(-1)[0]) for k, v in out.items()}
    design = CacheDesign(
        mem=p.mem, capacity_bytes=p.capacity_bytes,
        org=engine.ORGS[oi],
        read_latency_s=ppa["read_latency_s"],
        write_latency_s=ppa["write_latency_s"],
        read_energy_j=ppa["read_energy_j"],
        write_energy_j=ppa["write_energy_j"],
        leakage_w=ppa["leakage_w"],
        area_mm2=ppa["area_mm2"])
    if lowered.problem.objective == "edap":
        # a method: the reference reads it as an attribute and raises
        value = float(design.edap())
    else:
        spec = lowered.problem.sweep.resolve()
        tables = workload_engine.evaluate_platforms(
            spec.scenarios, (design,), spec.platforms, device=device)
        edp = np.stack([t.edp(lowered.problem.include_dram)
                        for t in tables])
        value = float(edp.mean())
    return {"value": value, "design": design, "ppa": ppa, "cell": cell}


def solve(problem: InverseProblem, device="cuda") -> InverseResult:
    """Full inverse solve on ``device``: lower, multi-start descent,
    harden, pick the best area-feasible start, verify through the
    standard path."""
    lowered = relax.lower(problem, device=device)
    theta0s = _theta_starts(lowered)
    thetas, losses = _solve_starts(lowered, theta0s)

    best = None
    for si in range(len(thetas)):
        obj, area = _harden(lowered, thetas[si])
        try:
            ki, oi = lowered.masked_argmin(obj, area)
        except ValueError:
            continue
        value = float(obj[ki, oi])
        if best is None or value < best[0]:
            best = (value, si, ki, oi)
    if best is None:
        raise ValueError(f"{problem.name}: no start produced an "
                         "area-feasible design")
    value, si, ki, oi = best
    theta = thetas[si]

    checked = verify(lowered, theta, ki, oi)
    parity = abs(value - checked["value"]) / abs(checked["value"])
    grid = grid_argmin(problem, lowered, device=lowered.device)

    active: dict[str, object] = {}
    for g in lowered.groups:
        for leaf, side in g.at_bound(theta).items():
            active[f"{g.flavor}/{g.node.name}.{leaf}"] = side
    budget = lowered.area_budget_mm2
    area_mm2 = checked["design"].area_mm2
    if budget is not None and area_mm2 >= 0.99 * budget:
        active["area_budget_mm2"] = True

    return InverseResult(
        problem=problem,
        leaves={g.key: g.leaves(theta) for g in lowered.groups},
        objective=problem.objective,
        best_value=value,
        standard_value=checked["value"],
        parity_rel_err=float(parity),
        grid_best_value=grid["value"],
        corner=lowered.corner_info(ki, oi),
        design=checked["design"],
        area_mm2=area_mm2,
        area_budget_mm2=budget,
        trajectory=tuple(float(x) for x in losses[si]),
        start_losses=tuple(float(x) for x in losses[:, -1]),
        converged_start=si,
        iterations=problem.iters,
        n_starts=problem.starts,
        active_constraints=active)
