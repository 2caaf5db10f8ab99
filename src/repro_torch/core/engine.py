"""Batched design-space engine — the full NVSim sweep as one computation.

DeepNVM++'s Algorithm 1 is an exhaustive sweep: every internal cache
organization (banks x rows x cols), every NVSim access type, every
optimization target, for every (technology, capacity) pair.  The scalar
path (core/cachemodel.py) walks that space one design point at a time;
this module evaluates it as a single batched tensor computation.

Representation: structure-of-arrays.  The organization grid is four flat
arrays (banks, rows, cols, access index) in exactly the order the scalar
``CacheModel.design_space`` iterates (itertools.product over the same
choices), so argmin tie-breaking matches the scalar ``min``.  Technology
nodes are rows of a node parameter matrix (NODE_FIELDS: the TechNode
supply/drive/sense/cell-area parameters followed by the node-derived
periphery building blocks of ``cachemodel.periphery``) and, per node,
technologies are rows of two parameter matrices — the characterized
bitcell vector (bitcell.ARRAY_FIELDS, node-dependent through the fin
sweep) and the calibration vector (CAL_FIELDS, node-dependent through the
derivation rule of calibration.get) — with capacities a further axis.
One torch function maps the cross product

    [node] x [tech] x [cap] x [org]  ->  PPA tensors of shape [n, m, c, o]

re-expressing every latency/energy/leakage/area equation of cachemodel.py
as a pure tensor function on the pipeline's device (``cuda`` unless the
caller passes ``device="cpu"``).  Every tensor is torch.float64 (int64 /
bool for indices and masks), so the batched numbers agree with the scalar
Python-float path to the last few ulps, keeping the Table I/II calibration
anchors intact.  A cross-node DTCO sweep (Mishty & Sadi 2023 run their
SOT-MRAM study per node by hand) is therefore one ``design_table`` call
with several nodes.

The PPA tensors come back to the host as numpy arrays once computed (a
[n, m, c, o] table is a few MB), and Algorithm 1 runs there, with the
reference's own masked argmin and strict-< EDAP pass, so its tie-breaking
does not depend on the device.

On top of the PPA tensors, :class:`DesignTable` implements Algorithm 1 as a
masked argmin per (optimization target, access type) — the same nominee
pool and the same first-strict-minimum EDAP tie-breaking as the scalar
``tuner.tune`` — plus vectorized feasibility queries (iso-area capacity
search) that need no per-capacity tuning at all.

``design_table`` memoizes fully-calibrated tables per (nodes, mems,
capacities, device) so every consumer — tuner, isocap, isoarea, scaling —
shares one evaluation of the sweep.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from repro_torch.core import bitcell as bitcell_mod
from repro_torch.core import device as device_mod
from repro_torch.core.cachemodel import (
    ACCESS_TYPES,
    ASSOC,
    BANK_CHOICES,
    COL_CHOICES,
    FLIP_P,
    LINE_BYTES,
    PERIPHERY_FIELDS,
    ROW_CHOICES,
    TAG_BITS,
    CacheDesign,
    CacheOrg,
    _SRAM_LAT_STRESS_EXP,
    _SRAM_LEAK_STRESS_EXP,
    _STRESS_ANCHOR_MB,
    periphery,
)
from repro_torch.core.tech import TechNode, TECH_16NM

MEMS = ("sram", "stt", "sot")

# Calibration parameters consumed by the PPA equations, in the order they
# are packed into the per-technology calibration matrix.
CAL_FIELDS = (
    "peri_area_lin",
    "peri_area_sqrt",
    "leak_lin",
    "leak_sqrt",
    "k_read_lat",
    "k_write_lat",
    "k_read_e",
    "k_write_e",
)

# TechNode parameters the equations read, followed by the node-derived
# periphery building blocks (cachemodel.Periphery, in PERIPHERY_FIELDS
# order) — packed as one per-node vector, so every node, the 16 nm anchor
# included, reads its periphery from the same runtime input.
TECHNODE_FIELDS = ("vdd_v", "ion_per_fin_a", "sense_voltage_v",
                   "sram_cell_area_um2")
NODE_FIELDS = TECHNODE_FIELDS + PERIPHERY_FIELDS
_N_TECHNODE = len(TECHNODE_FIELDS)

# --- structure-of-arrays organization grid ---------------------------------
# Same product order as CacheModel.design_space so masked argmins break ties
# identically to the scalar min() over the generated sequence.
_ORG_TUPLES = tuple(itertools.product(
    BANK_CHOICES, ROW_CHOICES, COL_CHOICES, range(len(ACCESS_TYPES))))
ORG_BANKS = np.array([t[0] for t in _ORG_TUPLES], dtype=np.int64)
ORG_ROWS = np.array([t[1] for t in _ORG_TUPLES], dtype=np.int64)
ORG_COLS = np.array([t[2] for t in _ORG_TUPLES], dtype=np.int64)
ORG_ACCESS = np.array([t[3] for t in _ORG_TUPLES], dtype=np.int64)
N_ORGS = len(_ORG_TUPLES)

ORGS = tuple(CacheOrg(banks=int(b), rows=int(r), cols=int(c),
                      access=ACCESS_TYPES[a])
             for b, r, c, a in _ORG_TUPLES)

_SEQ = ACCESS_TYPES.index("sequential")
_FAST = ACCESS_TYPES.index("fast")


def valid_mask(capacities_bytes: np.ndarray) -> np.ndarray:
    """[c, o] bool — CacheModel.design_space's feasibility filters."""
    caps = np.asarray(capacities_bytes, dtype=np.int64)[:, None]
    bits = caps * 8
    brc = (ORG_BANKS * ORG_ROWS * ORG_COLS)[None, :]
    degenerate = brc > 4 * bits
    # scalar path: float division, so mirror it bit-for-bit
    too_few = bits.astype(np.float64) / brc.astype(np.float64) > 4096
    return ~(degenerate | too_few)


def _ppa_kernel(cell, cal, is_sram, node, peri, caps_bytes, banks, rows,
                cols, acc):
    """PPA equations of cachemodel.py as one batched map.

    cell [n, m, 7] (bitcell.ARRAY_FIELDS), cal [n, m, 8] (CAL_FIELDS),
    is_sram [m], node [n, 4] (TECHNODE_FIELDS), peri [n, 7]
    (PERIPHERY_FIELDS), caps_bytes [c], banks/rows/cols/acc [o] — tensors
    on one device, float64 / bool / int64
    ->  dict of [n, m, c, o] / [n, m, c] float64 tensors on that device.

    Every expression keeps the scalar path's operation order so float64
    results match the Python-float reference to the last ulps.  A select
    between two constants is written with float64 tensors: torch.where of
    two Python floats would give the default dtype, float32.  They are
    filled on the device (``torch.full``), so a call copies nothing from
    the host: the inverse designer's loss runs this map every step.
    """
    f64 = torch.float64

    def const(x: float) -> torch.Tensor:
        return torch.full((), x, dtype=f64, device=cell.device)

    # broadcast axes: n = node, m = technology, c = capacity, o = org
    def M(x):      # [n, m] -> [n, m, 1, 1]
        return x[:, :, None, None]

    def N(x):      # [n] -> [n, 1, 1, 1]
        return x[:, None, None, None]

    (vdd, ion, sense_v, sram_cell_um2) = (N(node[:, i])
                                          for i in range(node.shape[1]))
    (t_gate_s, t_sense_amp_s, e_gate_j, htree_ns_per_mm, htree_pj_per_mm_bit,
     c_bitline_per_row_f, c_wordline_per_col_f) = (
        N(peri[:, i]) for i in range(peri.shape[1]))
    (i_read, sense_lat, sense_e, wlat_avg, we_avg, area_norm,
     cell_leak) = (M(cell[:, :, i]) for i in range(cell.shape[2]))
    (peri_area_lin, peri_area_sqrt, leak_lin, leak_sqrt,
     k_read_lat, k_write_lat, k_read_e, k_write_e) = (
        M(cal[:, :, i]) for i in range(cal.shape[2]))
    sram = is_sram[None, :, None, None]

    cap = caps_bytes[None, None, :, None].to(f64)             # [1, 1, c, 1]
    cap_mb = cap / 2**20
    data_bits = cap * 8
    tag_bits = torch.floor(cap / LINE_BYTES) * TAG_BITS
    bits_total = data_bits + tag_bits

    banks = banks[None, None, None, :].to(f64)                # [1, 1, 1, o]
    rows = rows[None, None, None, :].to(f64)
    cols = cols[None, None, None, :].to(f64)
    acc = acc[None, None, None, :]

    # -- geometry (CacheModel._subarrays / area_mm2 / _htree_mm) -----------
    n_sub = torch.ceil(bits_total / (rows * cols)).clamp_min(1.0)
    cell_um2 = area_norm * sram_cell_um2
    array_area = bits_total * cell_um2 * 1e-6 / 0.85          # mm2_from_um2
    peri_area = peri_area_lin * cap_mb + peri_area_sqrt * torch.sqrt(cap_mb)
    area = array_area + peri_area                             # [n, m, c, 1]
    htree_mm = torch.sqrt(area) * (1.0 + torch.log2(banks) / 8.0)

    stress_base = cap / 2**20 / _STRESS_ANCHOR_MB
    stress_lat = torch.where(sram, stress_base ** _SRAM_LAT_STRESS_EXP, 1.0)
    stress_leak = torch.where(sram, stress_base ** _SRAM_LEAK_STRESS_EXP, 1.0)

    # -- latency -----------------------------------------------------------
    decoder = torch.log2(rows) * t_gate_s
    c_wl = cols * c_wordline_per_col_f
    wordline = 2.2 * c_wl * (vdd / ion) * 0.05
    c_bl = rows * c_bitline_per_row_f
    bitline = c_bl * sense_v / i_read + sense_lat + t_sense_amp_s
    routing = 2.0 * t_gate_s * torch.log2(n_sub.clamp_min(2.0))
    ht_lat = htree_mm * htree_ns_per_mm * 1e-9

    array_t = decoder + wordline + bitline
    tag_t = decoder + wordline + 0.4 * bitline
    lat_seq = ht_lat + routing + tag_t + array_t + 2 * t_gate_s
    lat_fast = ht_lat + routing + array_t + t_gate_s
    lat_norm = ht_lat + routing + torch.maximum(tag_t, array_t) + 3 * t_gate_s
    read_lat = torch.where(acc == _SEQ, lat_seq,
                           torch.where(acc == _FAST, lat_fast, lat_norm))
    read_lat = read_lat * k_read_lat * stress_lat
    write_lat = (ht_lat + routing + decoder + wordline + wlat_avg) \
        * k_write_lat * stress_lat

    # -- energy ------------------------------------------------------------
    line_bits = LINE_BYTES * 8
    ways_sensed = torch.where(acc == _SEQ, const(1.0), const(float(ASSOC)))
    sense = line_bits * ways_sensed * sense_e
    bl_read = line_bits * ways_sensed * c_bl * vdd * vdd
    ht_e = htree_mm * htree_pj_per_mm_bit * 1e-12 * line_bits
    dec_e = torch.log2(rows) * 64 * e_gate_j
    route_e = n_sub * 4 * e_gate_j
    read_e = (sense + bl_read + ht_e + dec_e + route_e) * k_read_e

    flips = line_bits * torch.where(sram, const(1.0), const(FLIP_P))
    cellw = flips * we_avg
    bl_write = line_bits * c_bl * vdd * vdd * 2.0
    write_e = (cellw + bl_write + ht_e + dec_e + route_e) * k_write_e

    # -- leakage (org-independent, like CacheModel.leakage_w) --------------
    cells_leak = bits_total * cell_leak * stress_leak
    peri_leak = leak_lin * cap_mb + leak_sqrt * torch.sqrt(cap_mb)
    leakage = (cells_leak + peri_leak)[..., 0]                # [n, m, c]

    return dict(
        read_latency_s=read_lat,
        write_latency_s=write_lat,
        read_energy_j=read_e,
        write_energy_j=write_e,
        leakage_w=leakage,
        area_mm2=area[..., 0],
    )


# Public pure-function entry point to the batched PPA equations: the same
# callable the memoized ``design_table`` path runs, so a consumer calling
# it (parity tests, the dtype check) sees exactly the tensors the tables
# are built from, on the device its inputs lie on.
ppa_fn = _ppa_kernel


def node_row(node: TechNode) -> np.ndarray:
    """One [NODE_FIELDS] float64 row of the node parameter matrix: the
    TechNode supply/drive/sense/cell-area parameters followed by the
    node-derived periphery bundle — the per-node runtime input of
    ``ppa_fn`` (split as ``row[:len(TECHNODE_FIELDS)]`` / the rest)."""
    return np.concatenate([
        np.array([getattr(node, f) for f in TECHNODE_FIELDS],
                 dtype=np.float64),
        periphery(node).as_array()])


@dataclasses.dataclass(frozen=True)
class DesignTable:
    """Evaluated (node x tech x capacity x organization) sweep + Algorithm 1.

    Every accessor takes an optional ``node``; a single-node table (the
    common case) resolves it implicitly, a multi-node (DTCO) table requires
    it — there is no silent default to the first node.
    """

    nodes: tuple[TechNode, ...]
    mems: tuple[str, ...]
    capacities_bytes: tuple[int, ...]
    read_latency_s: np.ndarray     # [n, m, c, o]
    write_latency_s: np.ndarray    # [n, m, c, o]
    read_energy_j: np.ndarray      # [n, m, c, o]
    write_energy_j: np.ndarray     # [n, m, c, o]
    leakage_w: np.ndarray          # [n, m, c]
    area_mm2: np.ndarray           # [n, m, c]
    valid: np.ndarray              # [c, o] bool (node/tech-independent)

    # -- indexing ----------------------------------------------------------

    def _node_index(self, node: TechNode | None) -> int:
        if node is None:
            if len(self.nodes) == 1:
                return 0
            raise ValueError(
                f"table spans {len(self.nodes)} nodes "
                f"({', '.join(nd.name for nd in self.nodes)}); pass node=")
        try:
            return self.nodes.index(node)
        except ValueError:
            raise ValueError(f"node {node.name!r} not in table") from None

    def _nmc(self, mem: str, capacity_bytes: int,
             node: TechNode | None = None) -> tuple[int, int, int]:
        return (self._node_index(node), self.mems.index(mem),
                self.capacities_bytes.index(capacity_bytes))

    def design(self, mem: str, capacity_bytes: int, org_index: int,
               node: TechNode | None = None) -> CacheDesign:
        """Materialize one design point as the scalar-API dataclass."""
        n, m, c = self._nmc(mem, capacity_bytes, node)
        o = org_index
        return CacheDesign(
            mem=mem,
            capacity_bytes=capacity_bytes,
            org=ORGS[o],
            read_latency_s=float(self.read_latency_s[n, m, c, o]),
            write_latency_s=float(self.write_latency_s[n, m, c, o]),
            read_energy_j=float(self.read_energy_j[n, m, c, o]),
            write_energy_j=float(self.write_energy_j[n, m, c, o]),
            leakage_w=float(self.leakage_w[n, m, c]),
            area_mm2=float(self.area_mm2[n, m, c]),
        )

    def designs(self, mem: str, capacity_bytes: int,
                node: TechNode | None = None) -> list[CacheDesign]:
        """All valid design points, in scalar design_space order."""
        _, _, c = self._nmc(mem, capacity_bytes, node)
        return [self.design(mem, capacity_bytes, o, node=node)
                for o in np.flatnonzero(self.valid[c])]

    # -- Algorithm 1 -------------------------------------------------------

    def edap(self, mem: str, capacity_bytes: int,
             node: TechNode | None = None) -> np.ndarray:
        """[o] EDAP vector (scalar CacheDesign.edap operation order)."""
        n, m, c = self._nmc(mem, capacity_bytes, node)
        e = 0.5 * (self.read_energy_j[n, m, c] + self.write_energy_j[n, m, c])
        d = 0.5 * (self.read_latency_s[n, m, c]
                   + self.write_latency_s[n, m, c])
        return e * d * self.area_mm2[n, m, c]

    @functools.cached_property
    def _tuned_memo(self) -> dict[tuple[int, str, int], int]:
        # per-instance winner cache: every consumer (isocap/isoarea/scaling/
        # dtco/benchmarks) re-queries the same few (node, mem, capacity)
        return {}

    def tuned_index(self, mem: str, capacity_bytes: int,
                    node: TechNode | None = None) -> int:
        """Algorithm 1: masked argmin per (target, access) -> min-EDAP nominee.

        Matches tuner's scalar loop exactly: the OPT_TARGETS metric order,
        the ACCESS_TYPES pool order, first-occurrence argmin within each
        pool, and strict-< EDAP tie-breaking across nominees.  Memoized per
        (node, mem, capacity) on the table instance.
        """
        n, m, c = self._nmc(mem, capacity_bytes, node)
        memo = self._tuned_memo
        if (n, mem, capacity_bytes) in memo:
            return memo[n, mem, capacity_bytes]
        if not self.valid[c].any():
            raise ValueError(
                f"empty design space at {capacity_bytes} bytes")
        rl = self.read_latency_s[n, m, c]
        wl = self.write_latency_s[n, m, c]
        re_ = self.read_energy_j[n, m, c]
        we_ = self.write_energy_j[n, m, c]
        flat = np.full(N_ORGS, self.area_mm2[n, m, c])
        leak = np.full(N_ORGS, self.leakage_w[n, m, c])
        metrics = (rl, wl, re_, we_, rl * re_, wl * we_, flat, leak)
        edap = self.edap(mem, capacity_bytes, node)
        best = -1
        for metric in metrics:
            for a in range(len(ACCESS_TYPES)):
                pool = self.valid[c] & (ORG_ACCESS == a)
                if not pool.any():
                    continue
                nominee = int(np.argmin(np.where(pool, metric, np.inf)))
                if best < 0 or edap[nominee] < edap[best]:
                    best = nominee
        memo[n, mem, capacity_bytes] = best
        return best

    def tuned(self, mem: str, capacity_bytes: int,
              node: TechNode | None = None) -> CacheDesign:
        return self.design(mem, capacity_bytes,
                           self.tuned_index(mem, capacity_bytes, node),
                           node=node)

    # -- vectorized feasibility (iso-area) ---------------------------------

    def areas(self, mem: str, node: TechNode | None = None) -> np.ndarray:
        """[c] area vector — org-independent, so no tuning required."""
        return self.area_mm2[self._node_index(node), self.mems.index(mem)]

    # -- per-chunk slicing (sharded sweeps) --------------------------------

    def subset(self, mems: tuple[str, ...] | None = None,
               capacities_bytes: tuple[int, ...] | None = None,
               nodes: tuple[TechNode, ...] | None = None) -> DesignTable:
        """Slice a sub-table along the node/mem/capacity axes without
        re-evaluating the circuit sweep — the per-chunk design table of a
        sharded mega-sweep.  Algorithm-1 winners already memoized on this
        table are carried over (remapped to the child's node indices), so
        chunk lowering never re-runs a tuning the full table has done.
        """
        nodes = tuple(nodes) if nodes is not None else self.nodes
        mems = tuple(mems) if mems is not None else self.mems
        caps = tuple(int(c) for c in capacities_bytes) \
            if capacities_bytes is not None else self.capacities_bytes
        try:
            ni = [self.nodes.index(nd) for nd in nodes]
            mi = [self.mems.index(m) for m in mems]
            ci = [self.capacities_bytes.index(c) for c in caps]
        except ValueError as e:
            raise ValueError(f"subset axis not in table: {e}") from None
        sel3 = np.ix_(ni, mi, ci)
        child = DesignTable(
            nodes=nodes, mems=mems, capacities_bytes=caps,
            read_latency_s=self.read_latency_s[sel3],
            write_latency_s=self.write_latency_s[sel3],
            read_energy_j=self.read_energy_j[sel3],
            write_energy_j=self.write_energy_j[sel3],
            leakage_w=self.leakage_w[sel3],
            area_mm2=self.area_mm2[sel3],
            valid=self.valid[ci],
        )
        # carry over Algorithm-1 winners (org indices are axis-invariant:
        # the org grid and the per-capacity valid mask are shared)
        node_remap = {old: new for new, old in enumerate(ni)}
        child._tuned_memo.update(
            {(node_remap[n], mem, cap): org
             for (n, mem, cap), org in self._tuned_memo.items()
             if n in node_remap and mem in mems and cap in caps})
        return child


def _as_nodes(nodes) -> tuple[TechNode, ...]:
    """Normalize a single TechNode or a sequence of them to a tuple."""
    return (nodes,) if isinstance(nodes, TechNode) else tuple(nodes)


def _per_node(seq, n_nodes: int, what: str):
    """Normalize explicit cells/cals to a per-node nested tuple: a flat
    per-mem sequence is accepted for single-node sweeps (the tuner and the
    calibration fixed point pass trial values that way)."""
    seq = tuple(seq)
    if seq and not isinstance(seq[0], (tuple, list)):
        seq = (seq,)
    if len(seq) != n_nodes:
        raise ValueError(f"{what} must be given per node "
                         f"({len(seq)} rows for {n_nodes} nodes)")
    return tuple(tuple(row) for row in seq)


def _tech_matrices(mems, cells, cals, nodes, device):
    if cells is None:
        cells = tuple(tuple(bitcell_mod.characterize(m, nd) for m in mems)
                      for nd in nodes)
    else:
        cells = _per_node(cells, len(nodes), "cells")
    if cals is None:
        from repro_torch.core import calibration  # deferred: get() calls back here
        cals = tuple(tuple(calibration.get(m, nd, device=device) for m in mems)
                     for nd in nodes)
    else:
        cals = _per_node(cals, len(nodes), "cals")
    cell_mat = np.stack([np.stack([c.as_array() for c in row])
                         for row in cells])
    cal_mat = np.array([[[getattr(cal, f) for f in CAL_FIELDS]
                         for cal in row] for row in cals], dtype=np.float64)
    is_sram = np.array([m == "sram" for m in mems])
    node_mat = np.stack([node_row(nd) for nd in nodes])
    return cell_mat, cal_mat, is_sram, node_mat


def _run_kernel(cell_mat, cal_mat, is_sram, node_mat, caps_arr,
                banks, rows, cols, acc, device: str) -> dict[str, np.ndarray]:
    """Run the PPA equations on ``device`` and bring the tensors home.

    Every node row, the 16 nm anchor included, goes through the one code
    path with its periphery as a runtime input (the reference compiles the
    anchor's periphery in as constants; the numbers agree within a few
    ulps).  Inputs cross to the device as float64 / bool / int64 tensors;
    the outputs come back as float64 numpy arrays.
    """
    out = _ppa_kernel(*(device_mod.put(a, device) for a in (
        cell_mat, cal_mat, is_sram, node_mat[:, :_N_TECHNODE],
        node_mat[:, _N_TECHNODE:], caps_arr, banks, rows, cols, acc)))
    return {k: v.cpu().numpy() for k, v in out.items()}


def evaluate(capacities_bytes, orgs, mems=MEMS, cells=None, cals=None,
             nodes: TechNode | tuple[TechNode, ...] = TECH_16NM,
             device: str | torch.device = "cuda",
             ) -> dict[str, np.ndarray]:
    """Raw batched evaluation over an arbitrary organization list.

    Returns the PPA tensors keyed like CacheDesign fields: [n, m, c, o] for
    the org-dependent quantities, [n, m, c] for leakage/area.  ``orgs`` may
    be any sequence of CacheOrg (not just the standard grid) — this is what
    makes the scalar ``CacheModel.evaluate`` a one-element batch.
    """
    device = device_mod.resolve(device)
    nodes = _as_nodes(nodes)
    mems = tuple(mems)
    caps_arr = np.array([int(c) for c in capacities_bytes], dtype=np.int64)
    banks = np.array([o.banks for o in orgs], dtype=np.int64)
    rows = np.array([o.rows for o in orgs], dtype=np.int64)
    cols = np.array([o.cols for o in orgs], dtype=np.int64)
    acc = np.array([ACCESS_TYPES.index(o.access) for o in orgs],
                   dtype=np.int64)
    cell_mat, cal_mat, is_sram, node_mat = _tech_matrices(
        mems, cells, cals, nodes, device)
    return _run_kernel(cell_mat, cal_mat, is_sram, node_mat, caps_arr,
                       banks, rows, cols, acc, device)


def sweep(capacities_bytes, mems=MEMS, cells=None, cals=None,
          nodes: TechNode | tuple[TechNode, ...] = TECH_16NM,
          device: str | torch.device = "cuda") -> DesignTable:
    """Evaluate the full (nodes x mems x capacities x orgs) cross product.

    ``cells``/``cals`` default to the characterized bitcell and fitted
    calibration per (node, technology); the calibration fixed point passes
    trial values explicitly (which is why this function must not call
    calibration.get itself).
    """
    device = device_mod.resolve(device)
    nodes = _as_nodes(nodes)
    mems = tuple(mems)
    caps = tuple(int(c) for c in capacities_bytes)
    cell_mat, cal_mat, is_sram, node_mat = _tech_matrices(
        mems, cells, cals, nodes, device)
    caps_arr = np.array(caps, dtype=np.int64)
    out = _run_kernel(cell_mat, cal_mat, is_sram, node_mat, caps_arr,
                      ORG_BANKS, ORG_ROWS, ORG_COLS, ORG_ACCESS, device)
    return DesignTable(
        nodes=nodes,
        mems=mems,
        capacities_bytes=caps,
        read_latency_s=out["read_latency_s"],
        write_latency_s=out["write_latency_s"],
        read_energy_j=out["read_energy_j"],
        write_energy_j=out["write_energy_j"],
        leakage_w=out["leakage_w"],
        area_mm2=out["area_mm2"],
        valid=valid_mask(caps_arr),
    )


@functools.lru_cache(maxsize=None)
def _design_table_cached(nodes: tuple[TechNode, ...],
                         mems: tuple[str, ...],
                         capacities_bytes: tuple[int, ...],
                         device: str) -> DesignTable:
    return sweep(capacities_bytes, mems=mems, nodes=nodes, device=device)


def design_table(mems: tuple[str, ...],
                 capacities_bytes: tuple[int, ...],
                 nodes: TechNode | tuple[TechNode, ...] = TECH_16NM,
                 device: str | torch.device = "cuda",
                 ) -> DesignTable:
    """Memoized fully-calibrated table — the shared sweep every consumer
    (tuner, isocap, isoarea, scaling, benchmarks) reads from.

    The memo key is (nodes, mems, capacities, device): a non-default node
    gets its own table (a node-blind key would serve every node the 16 nm
    tables), and so does each device, whose last ulps may differ."""
    return _design_table_cached(_as_nodes(nodes), tuple(mems),
                                tuple(int(c) for c in capacities_bytes),
                                device_mod.resolve(device))


design_table.cache_clear = _design_table_cached.cache_clear
design_table.cache_info = _design_table_cached.cache_info


def warmup(cap_counts: tuple[int, ...] = (1, 2, 4),
           nodes: TechNode | tuple[TechNode, ...] = TECH_16NM,
           mems: tuple[str, ...] = MEMS,
           device: str | torch.device = "cuda") -> int:
    """Build one dummy table per capacity count and prime the layers in
    front of the PPA equations (bitcell characterization, the calibration
    fixed point, the periphery bundle) and the device (its context and
    kernels load on the first call).

    The dummy tables land in the ``design_table`` memo under capacities no
    real sweep uses (1 MB + small offsets); they are never tuned, so the
    Algorithm-1 memo stays untouched.  Returns the number of tables built.
    """
    nodes = _as_nodes(nodes)
    mems = tuple(mems)
    for count in cap_counts:
        caps = tuple((1 << 20) + 64 * i for i in range(count))
        design_table(mems, caps, nodes=nodes, device=device)
    return len(cap_counts)
