"""The differentiable lowering: device leaves -> soft bitcells -> PPA ->
workload fold -> softmin-selected objective, in float64 torch.

This is the unmemoized, non-argmin variant of the standard pipeline.
Three discrete choices become temperature-annealed softmin relaxations:

* the **fin assignment** of each NVM bitcell (the ``bitcell.
  fin_assignments`` grid): every assignment's 7-vector is evaluated with
  the *same scalar operation order* as ``bitcell._evaluate``, one
  assignment per element of a vector (at a hard temperature the mixture
  weights are exactly one-hot, so the cell matches the winning
  assignment's vector to the few ulps the ``exp(ln(anchor))`` theta
  round-trip introduces), infeasible assignments (write current below
  Ic0) are masked with -inf logits, and the mixture weights are a
  softmin over the bitcell EDAP;
* the **(mem, capacity, node) corner x organization** selection: one
  ``engine.ppa_fn`` call over the unique node/mem/capacity cross
  product (the same torch map the memoized path runs), the per-corner
  tensors are gathered by index tensors, the workload objective folds
  through ``workload_engine._fold``, and a joint softmin over all valid
  (corner, org) cells yields the relaxed objective and area;
* the **STT scaling wall**: instead of ``characterize``'s raised
  diagnostic, the best overdrive across assignments enters the loss as
  a softplus penalty, so the optimizer feels the wall as a smooth
  gradient (and the extrapolated 2 nm node is a finite, differentiable
  point instead of an exception).

Everything discrete about the problem (the spec axes, the assignment
grids, the validity masks, platform/stream tensors) is made once, at
lowering time, as tensors on the lowering's device; the traced functions
are pure maps from ``theta = ln(leaves)`` (and a temperature) to
scalars that copy nothing between the host and the device, so the
driver can ``torch.func.vmap`` / ``grad`` / ``jacfwd`` them freely.

Ties and softplus follow JAX's gradients: ``torch.minimum`` /
``torch.maximum`` / ``amax`` split a tie's gradient evenly (the SOT
anchor has ``ic0_set == ic0_reset``, so the centres sit on one), and
softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is
(``torch.nn.functional.softplus`` switches to ``x`` above 20).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import bitcell as bitcell_mod
from repro_torch.core import calibration, engine, workload_engine
from repro_torch.core import device as device_mod
from repro_torch.core.bitcell import (
    _AREA_PER_FIN,
    _I_READ_PER_FIN,
    _STT_READ_CAP_FRAC,
    _bitcell_scale,
)
from repro_torch.core.sweep import DesignPoint
from repro_torch.core.tech import TechNode
from repro_torch.inverse import bounds
from repro_torch.inverse.bounds import LeafGroup, N_LEAVES
from repro_torch.inverse.problem import InverseProblem

# Temperature at which the softmins are exactly one-hot in float64 (the
# smallest log-metric gaps in this model are ~1e-2; 1e-2 / 1e-4 = 100
# nats underflows the runner-up weight to exactly 0.0).
HARD_TEMP = 1e-4

# Overdrive scale of the scaling-wall softplus penalty: the wall "turns
# on" within ~0.05 of zero overdrive.
WALL_SCALE = 0.05
LAMBDA_WALL = 10.0
# Area-budget hinge: softplus((soft_area/budget - 1) / SIGMA) — stiff
# within ~1% of the budget.
SIGMA_AREA = 0.01
LAMBDA_AREA = 50.0

# Overdrive clamp for masked (infeasible) assignments: keeps the masked
# branch finite (inf * 0 would poison the softmin mixture's gradients)
# without perturbing any feasible overdrive the sweep would accept.
_OD_FLOOR = 1e-30

F64 = torch.float64


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True, eq=False)
class Assignments:
    """The fin grid of one (flavor, node) group as [A] float64 tensors,
    one element per ``bitcell.fin_assignments`` entry (scalar op order
    preserved elementwise)."""

    i_write_a: torch.Tensor     # bitcell._write_current(node, fins_write)
    i_read_raw_a: torch.Tensor  # read current before the STT disturb cap
    fin_area_norm: torch.Tensor  # the fins' footprint term
    cell_leak_w: torch.Tensor


@functools.lru_cache(maxsize=None)
def _assignment_rows(flavor: str, node: TechNode) -> np.ndarray:
    """[4, A] float64: i_write, raw i_read, fin area, leakage per
    assignment."""
    rows = []
    for fr, fw, shared in bitcell_mod.fin_assignments(flavor):
        total_fins = fw if shared else fr + fw
        rows.append((
            bitcell_mod._write_current(node, fw),
            fr * _I_READ_PER_FIN[flavor]
            * _bitcell_scale("i_read_per_fin", node),
            _AREA_PER_FIN * _bitcell_scale("area_per_fin", node) * total_fins,
            total_fins * node.ioff_per_fin_a * node.vdd_v))
    return np.array(rows, dtype=np.float64).T


def assignments(group: LeafGroup, device) -> Assignments:
    """The group's fin-grid constants as tensors on ``device``."""
    return Assignments(*(device_mod.put(r, str(device))
                         for r in _assignment_rows(group.flavor, group.node)))


def soft_cell(theta_g, group: LeafGroup, temp,
              fins: Assignments | None = None):
    """Softmin fin-assignment mixture of one NVM (flavor, node) group.

    ``theta_g`` is the group's ln-leaf slice (float64 tensor); ``fins``
    its :class:`Assignments` (made on ``theta_g``'s device if omitted).
    Returns (cell [7] in bitcell.ARRAY_FIELDS order, best overdrive
    across assignments — the scaling-wall signal, > 0 iff some
    assignment is feasible).

    Every per-assignment expression mirrors ``bitcell._evaluate`` /
    ``mtj.switching_time`` / ``mtj.switching_energy`` operation order;
    at :data:`HARD_TEMP` the mixture weights are exactly one-hot, so
    the cell equals the winning assignment's ``Bitcell.as_array()`` up
    to the few ulps of the ``exp(ln(anchor))`` theta round-trip.
    """
    if fins is None:
        fins = assignments(group, theta_g.device)
    (ic0_set_a, ic0_reset_a, tau_set_s, tau_reset_s, r_set_ohm,
     r_reset_ohm, sense_time_s, area_base) = (
        torch.exp(theta_g[i]) for i in range(N_LEAVES))
    floor = torch.full((), _OD_FLOOR, dtype=F64, device=theta_g.device)
    i_write = fins.i_write_a
    od_set = i_write / ic0_set_a - 1.0
    od_reset = i_write / ic0_reset_a - 1.0
    od_min = torch.minimum(od_set, od_reset)
    t_set_s = tau_set_s / torch.maximum(od_set, floor)
    t_reset_s = tau_reset_s / torch.maximum(od_reset, floor)
    if group.flavor == "stt":
        i_read_a = torch.minimum(fins.i_read_raw_a,
                                 _STT_READ_CAP_FRAC * ic0_set_a)
    else:
        i_read_a = fins.i_read_raw_a
    sense_e_j = group.node.vdd_v * i_read_a * sense_time_s
    e_set_j = i_write * i_write * r_set_ohm * t_set_s
    e_reset_j = i_write * i_write * r_reset_ohm * t_reset_s
    wlat_avg_s = 0.5 * (t_set_s + t_reset_s)
    we_avg_j = 0.5 * (e_set_j + e_reset_j)
    area_norm = area_base + fins.fin_area_norm
    vecs = torch.stack(torch.broadcast_tensors(
        i_read_a, sense_time_s, sense_e_j, wlat_avg_s, we_avg_j, area_norm,
        fins.cell_leak_w), dim=1)                              # [A, 7]
    edap = (sense_time_s * sense_e_j + wlat_avg_s * we_avg_j) * area_norm
    od_best = od_min.amax()
    logits = torch.where(od_min > 0.0, -torch.log(edap) / temp, -math.inf)
    w = torch.softmax(logits, dim=0)
    cell = (w[:, None] * vecs).sum(dim=0)
    return cell, od_best


def _iso_budget(areas_mm2: np.ndarray) -> float:
    """The "iso" area budget: the largest grid-corner area — every grid
    corner is admissible, and the optimum is compared at equal area."""
    return float(np.max(areas_mm2))


@dataclasses.dataclass(frozen=True, eq=False)
class Lowered:
    """A problem lowered to pure torch functions of theta.

    Static structure (axes, index maps, stream/platform tensors, leaf
    groups and bounds) is made at lowering time on ``device``;
    :meth:`loss`, :meth:`objective_matrix` and :meth:`scenario_objective`
    are pure maps suitable for ``torch.func`` transforms.  Build via
    :func:`lower`.  ``theta0`` / ``theta_lo`` / ``theta_hi`` stay numpy
    (the driver draws its starts from them on the host).
    """

    problem: InverseProblem
    device: str
    points: tuple[DesignPoint, ...]
    groups: tuple[LeafGroup, ...]
    fins: tuple[Assignments, ...]  # per group
    theta0: np.ndarray           # centers, ln space
    theta_lo: np.ndarray
    theta_hi: np.ndarray
    area_budget_mm2: float | None
    # unique-axis structure
    nodes: tuple[TechNode, ...]
    mems: tuple[str, ...]
    caps: tuple[int, ...]
    nk: torch.Tensor             # [k] node index per point (int64)
    mk: torch.Tensor             # [k] mem index
    ck: torch.Tensor             # [k] capacity index
    # kernel constants
    cal_mat: torch.Tensor        # [n, m, 8]
    is_sram: torch.Tensor        # [m]
    node4: torch.Tensor          # [n, 4]
    peri: torch.Tensor           # [n, 7]
    caps_arr: torch.Tensor       # [c] int64
    orgs: tuple[torch.Tensor, ...]  # banks, rows, cols, access [o] int64
    const_cells: dict            # (ni, mi) -> [7] row (non-relaxed)
    relaxed: dict                # (ni, mi) -> group index
    valid: torch.Tensor          # [k, o] bool
    valid_host: np.ndarray       # the same mask on the host
    caps_k: torch.Tensor         # [k] float64 capacity per point
    # fold constants ("edp" objective)
    batch: workload_engine.StreamBatch | None   # fields are tensors
    pmat: torch.Tensor | None

    # -- the relaxed pipeline ----------------------------------------------

    def _cell_mat(self, theta, temp):
        """[n, m, 7] cell matrix: soft NVM rows, constant sram rows; also
        the per-group best overdrives (the scaling-wall signals)."""
        cells = {}
        od_bests = [None] * len(self.groups)
        for (ni, mi), gi in self.relaxed.items():
            g = self.groups[gi]
            sl = theta[g.offset:g.offset + N_LEAVES]
            cell, od_best = soft_cell(sl, g, temp, self.fins[gi])
            cells[(ni, mi)] = cell
            od_bests[gi] = od_best
        rows = [torch.stack([
            cells[(ni, mi)] if (ni, mi) in cells
            else self.const_cells[(ni, mi)]
            for mi in range(len(self.mems))])
            for ni in range(len(self.nodes))]
        return torch.stack(rows), od_bests

    def _ppa(self, theta, temp):
        """Gathered per-point PPA: (rl, wl, re, we) [k, o], leak/area [k],
        plus the per-group overdrives."""
        cell_mat, od_bests = self._cell_mat(theta, temp)
        out = engine.ppa_fn(cell_mat, self.cal_mat, self.is_sram,
                            self.node4, self.peri, self.caps_arr, *self.orgs)
        nk, mk, ck = self.nk, self.mk, self.ck
        return (out["read_latency_s"][nk, mk, ck],
                out["write_latency_s"][nk, mk, ck],
                out["read_energy_j"][nk, mk, ck],
                out["write_energy_j"][nk, mk, ck],
                out["leakage_w"][nk, mk, ck],
                out["area_mm2"][nk, mk, ck],
                od_bests)

    def _fold_edp(self, rl, wl, re_, we_, leak):
        """[p, s, k, o] EDP through the workload fold (the scalar
        WorkloadTable.edp operation order).  Only PPA quantities depend
        on theta: the streams, their reuse distances (inf on some, which
        gives inf/inf in ``_miss_tx``'s unselected branch) and the
        capacities are constants, so no NaN reaches a gradient."""
        k, o = rl.shape
        b = self.batch
        out = workload_engine._fold(
            b.bytes_total, b.is_write, b.reuse_distance,
            b.dram_visible, b.mask, b.macs,
            rl.reshape(-1), wl.reshape(-1), re_.reshape(-1),
            we_.reshape(-1), leak[:, None].expand(k, o).reshape(-1),
            self.caps_k[:, None].expand(k, o).reshape(-1), self.pmat)
        total = out["dyn_read_j"][None] + out["dyn_write_j"][None] \
            + out["leak_j"]
        if self.problem.include_dram:
            total = total + out["dram_j"]
        edp = total * out["runtime_s"]                     # [p, s, k*o]
        return edp.reshape(edp.shape[0], edp.shape[1], k, o)

    def _objective(self, rl, wl, re_, we_, leak, area):
        """[k, o] objective tensor from gathered PPA quantities.  Shared
        by the relaxed path and :meth:`grid_objective`, so softmin ->
        argmin recovery is consistent by construction."""
        if self.problem.objective == "edap":
            e = 0.5 * (re_ + we_)
            d = 0.5 * (rl + wl)
            return e * d * area[:, None]
        edp = self._fold_edp(rl, wl, re_, we_, leak)
        return edp.mean(dim=(0, 1))

    def objective_matrix(self, theta, temp=HARD_TEMP):
        """([k, o] objective, [k] area, per-group overdrives) at the
        given fin-mixture temperature."""
        rl, wl, re_, we_, leak, area, od_bests = self._ppa(theta, temp)
        return self._objective(rl, wl, re_, we_, leak, area), area, od_bests

    def loss(self, theta, temp):
        """The annealed scalar loss: softmin objective + area hinge +
        scaling-wall penalty (target mode squares the log residual)."""
        obj, area, od_bests = self.objective_matrix(theta, temp)
        obj_safe = torch.where(self.valid, obj, 1.0)
        logits = torch.where(self.valid, -torch.log(obj_safe) / temp,
                             -math.inf).reshape(-1)
        w = torch.softmax(logits, dim=0).reshape(obj.shape)
        soft_obj = (w * obj_safe).sum()
        soft_area = (w.sum(dim=1) * area).sum()
        if self.problem.target is not None:
            out = (torch.log(soft_obj)
                   - math.log(self.problem.target)) ** 2
        else:
            out = torch.log(soft_obj)
        if self.area_budget_mm2 is not None:
            out = out + LAMBDA_AREA * softplus(
                (soft_area / self.area_budget_mm2 - 1.0) / SIGMA_AREA)
        for od_best in od_bests:
            out = out + LAMBDA_WALL * softplus(-od_best / WALL_SCALE)
        return out

    def wall_penalty(self, theta):
        """The scaling-wall penalty alone (diagnostic; ~0 when every
        group has overdrive headroom, large past the wall)."""
        _, od_bests = self._cell_mat(theta, HARD_TEMP)
        pen = 0.0
        for od_best in od_bests:
            pen = pen + LAMBDA_WALL * softplus(-od_best / WALL_SCALE)
        return pen

    def scenario_objective(self, theta, org_idx: tuple[int, ...]):
        """ln objective per (platform, scenario) at fixed per-point orgs
        — the sensitivity layer's map ([p, s, k]; "edap" has no scenario
        axis and returns ln EDAP [1, 1, k])."""
        rl, wl, re_, we_, leak, area, _ = self._ppa(theta, HARD_TEMP)
        oi = device_mod.put(np.asarray(org_idx, dtype=np.int64), self.device)
        kk = torch.arange(len(self.points), device=self.device)
        if self.problem.objective == "edap":
            e = 0.5 * (re_[kk, oi] + we_[kk, oi])
            d = 0.5 * (rl[kk, oi] + wl[kk, oi])
            return torch.log(e * d * area)[None, None, :]
        edp = self._fold_edp(rl[kk, oi][:, None], wl[kk, oi][:, None],
                             re_[kk, oi][:, None], we_[kk, oi][:, None],
                             leak)
        return torch.log(edp[..., 0])

    # -- hardened / reference evaluations ----------------------------------

    def masked_argmin(self, obj: np.ndarray, area: np.ndarray,
                      ) -> tuple[int, int]:
        """(point, org) argmin over valid cells within the area budget,
        on the host (numpy's first-minimum tie order)."""
        mask = np.array(self.valid_host)
        if self.area_budget_mm2 is not None:
            mask = mask & (np.asarray(area)[:, None]
                           <= self.area_budget_mm2 * (1.0 + 1e-9))
        if not mask.any():
            raise ValueError("no (corner, org) cell satisfies the area "
                             f"budget {self.area_budget_mm2} mm^2")
        flat = int(np.argmin(np.where(mask, np.asarray(obj), np.inf)))
        return flat // engine.N_ORGS, flat % engine.N_ORGS

    def grid_objective(self) -> tuple[np.ndarray, np.ndarray]:
        """([k, o] objective, [k] area) through the standard memoized
        engine path (``engine.design_table``) with anchor leaves — the
        grid-argmin reference the relaxation is checked against."""
        table = engine.design_table(self.mems, self.caps, nodes=self.nodes,
                                    device=self.device)
        nk, mk, ck = (t.cpu().numpy() for t in (self.nk, self.mk, self.ck))

        def gather(a):
            return device_mod.put(a[nk, mk, ck], self.device)

        obj = self._objective(
            gather(table.read_latency_s), gather(table.write_latency_s),
            gather(table.read_energy_j), gather(table.write_energy_j),
            gather(table.leakage_w), gather(table.area_mm2))
        return obj.cpu().numpy(), np.asarray(table.area_mm2[nk, mk, ck])

    def corner_info(self, ki: int, oi: int) -> dict:
        """Human-readable identity of one (point, org) cell."""
        p = self.points[ki]
        org = engine.ORGS[oi]
        return {"mem": p.mem, "capacity_mb": p.capacity_mb,
                "node": p.node.name, "org_index": oi,
                "org": f"{org.banks}b x {org.rows}r x {org.cols}c "
                       f"x {org.access}"}


def _put_batch(batch: workload_engine.StreamBatch, device: str,
               ) -> workload_engine.StreamBatch:
    """The packed streams with every array field as a tensor on
    ``device``."""
    return dataclasses.replace(batch, **{
        f.name: device_mod.put(getattr(batch, f.name), device)
        for f in dataclasses.fields(batch) if f.name != "keys"})


def lower(problem: InverseProblem, device="cuda") -> Lowered:
    """Lower a problem to its static structure + torch functions on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``; raises
    without CUDA)."""
    device = device_mod.resolve(device)
    spec = problem.sweep.resolve()
    points = spec.designs
    groups = bounds.leaf_groups(points)
    if not groups:
        raise ValueError(f"{problem.name}: no NVM design points — nothing "
                         "to optimize (every leaf is an MRAM device knob)")
    theta0 = bounds.pack_theta(groups)
    theta_lo, theta_hi = bounds.theta_bounds(groups)

    nodes = tuple(dict.fromkeys(p.node for p in points))
    mems = tuple(dict.fromkeys(p.mem for p in points))
    caps = tuple(dict.fromkeys(p.capacity_bytes for p in points))
    nk = np.array([nodes.index(p.node) for p in points])
    mk = np.array([mems.index(p.mem) for p in points])
    ck = np.array([caps.index(p.capacity_bytes) for p in points])

    group_index = {g.key: i for i, g in enumerate(groups)}
    const_cells, relaxed = {}, {}
    for ni, nd in enumerate(nodes):
        for mi, mem in enumerate(mems):
            key = (mem, nd.name)
            if key in group_index:
                relaxed[(ni, mi)] = group_index[key]
            elif mem == "sram":
                const_cells[(ni, mi)] = \
                    bitcell_mod.characterize(mem, nd).as_array()
            else:
                # an (NVM, node) combo no design point uses: the kernel
                # still wants a row; its outputs are never gathered
                const_cells[(ni, mi)] = np.ones(
                    len(bitcell_mod.ARRAY_FIELDS))
    cal_mat = np.array([[[getattr(calibration.get(m, nd, device=device), f)
                          for f in engine.CAL_FIELDS]
                         for m in mems] for nd in nodes])
    is_sram = np.array([m == "sram" for m in mems])
    node_mat = np.stack([engine.node_row(nd) for nd in nodes])
    n_technode = len(engine.TECHNODE_FIELDS)
    caps_arr = np.array(caps, dtype=np.int64)

    if problem.objective == "edp":
        stats = spec.scenarios
        batch = _put_batch(workload_engine.pack(stats), device)
        pmat = device_mod.put(np.stack([
            np.array([getattr(p, f)
                      for f in workload_engine.PLATFORM_FIELDS])
            for p in spec.platforms]), device)
    else:
        batch, pmat = None, None

    def put(a):
        return device_mod.put(np.asarray(a), device)

    valid = engine.valid_mask(caps_arr)[ck]
    lowered = Lowered(
        problem=problem, device=device, points=points, groups=groups,
        fins=tuple(assignments(g, device) for g in groups),
        theta0=theta0, theta_lo=theta_lo, theta_hi=theta_hi,
        area_budget_mm2=None,
        nodes=nodes, mems=mems, caps=caps,
        nk=put(nk), mk=put(mk), ck=put(ck),
        cal_mat=put(cal_mat), is_sram=put(is_sram),
        node4=put(node_mat[:, :n_technode]),
        peri=put(node_mat[:, n_technode:]),
        caps_arr=put(caps_arr),
        orgs=tuple(put(a) for a in (engine.ORG_BANKS, engine.ORG_ROWS,
                                    engine.ORG_COLS, engine.ORG_ACCESS)),
        const_cells={key: put(row) for key, row in const_cells.items()},
        relaxed=relaxed, valid=put(valid), valid_host=valid,
        caps_k=put(np.array([float(p.capacity_bytes) for p in points])),
        batch=batch, pmat=pmat)

    budget = problem.area_budget_mm2
    if budget == "iso":
        _, grid_areas = lowered.grid_objective()
        budget = _iso_budget(grid_areas)
    if budget is not None:
        budget = float(budget)
    return dataclasses.replace(lowered, area_budget_mm2=budget)


def lowered_on(problem: InverseProblem, lowered: Lowered | None,
               device) -> Lowered:
    """``lowered``, or ``problem`` lowered on ``device``; raises if a given
    ``lowered`` lives on another device (or without CUDA, for "cuda")."""
    device = device_mod.resolve(device)
    if lowered is None:
        return lower(problem, device=device)
    if lowered.device != device:
        raise ValueError(f"lowered on {lowered.device}, asked to run on "
                         f"{device}")
    return lowered
