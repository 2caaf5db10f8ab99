"""Continuous leaves and node-aware bounds of the inverse problem.

A *leaf* is one device/bitcell anchor the optimizer may move: the MTJ
compact-model constants that actually enter the PPA equations (Ic0 per
polarity, the precessional time constants, the write-path resistances,
the sense window) plus the fin-independent bitcell footprint term.  The
read-path resistance is deliberately **not** a leaf — it never enters a
PPA expression (sensing is current-mode in this model), so its gradient
is identically zero and exposing it would only produce dead axes.

Leaves live per (flavor, node) *group*: each NVM technology at each
technology node of the problem's design axis gets its own copy, centered
on the node-projected anchor (``mtj.device`` / ``bitcell.base_area_norm``
— exactly the values the standard characterization path uses, so a
center evaluation reproduces the grid model).  Bounds are multiplicative
spans around the center derived from the documented scaling-exponent
tables: a knob whose 16 -> 7 nm projection moves by ``s**e`` is allowed
at least that much headroom in either direction (floored at 2x), i.e.
the optimizer may trade a knob across the whole validated projection
range but not into fantasy-device territory.

The optimizer works in theta = ln(leaf) space (multiplicative moves,
scale-free gradients); :func:`pack_theta` / :func:`theta_bounds` build
the flat vectors, and each group knows its slice of theta.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import bitcell, mtj, tech
from repro_torch.core.tech import TechNode, TECH_16NM, MIN_FEATURE_SIZE_M

# The exposed leaves, in theta packing order.  The first seven are
# MTJDevice fields; area_base_norm is the bitcell footprint term.
LEAF_FIELDS = (
    "ic0_set_a",
    "ic0_reset_a",
    "tau_set_s",
    "tau_reset_s",
    "r_set_ohm",
    "r_reset_ohm",
    "sense_time_s",
    "area_base_norm",
)
DEVICE_LEAVES = LEAF_FIELDS[:-1]
N_LEAVES = len(LEAF_FIELDS)

# Multiplicative half-span floor: every leaf may at least halve/double.
_SPAN_FLOOR = 2.0
# The validated projection range end-to-end: 16 nm anchor to the 7 nm
# MIN_FEATURE_SIZE_M wall.
_RANGE_RATIO = TECH_16NM.feature_size_m / MIN_FEATURE_SIZE_M


def leaf_span(flavor: str, field: str) -> float:
    """Multiplicative half-span of one leaf: how far the documented node
    scaling (``s**e`` across the full validated 16 -> 7 nm range) moves
    it, floored at :data:`_SPAN_FLOOR`."""
    if field == "area_base_norm":
        e = tech.BITCELL_SCALING_EXPONENTS["area_base"]
    else:
        e = tech.MTJ_SCALING_EXPONENTS[flavor][field]
    return max(_SPAN_FLOOR, _RANGE_RATIO ** abs(e))


def leaf_centers(flavor: str, node: TechNode) -> dict[str, float]:
    """Node-projected anchor value of every leaf — the values the
    standard characterization path (``mtj.device`` + ``bitcell``) uses,
    so theta at the centers reproduces the grid model exactly."""
    dev = mtj.device(flavor, node)
    centers = {f: getattr(dev, f) for f in DEVICE_LEAVES}
    centers["area_base_norm"] = bitcell.base_area_norm(flavor, node)
    return centers


@dataclasses.dataclass(frozen=True)
class LeafGroup:
    """One (flavor, node) copy of the leaves with centers and bounds.

    ``offset`` is the group's position in the flat theta vector: its
    leaves occupy ``theta[offset : offset + N_LEAVES]`` in LEAF_FIELDS
    order.
    """

    flavor: str
    node: TechNode
    offset: int
    centers: tuple[float, ...]   # [N_LEAVES] anchor values
    lo: tuple[float, ...]        # [N_LEAVES] lower bounds
    hi: tuple[float, ...]        # [N_LEAVES] upper bounds

    @property
    def key(self) -> tuple[str, str]:
        return (self.flavor, self.node.name)

    def leaves(self, theta: np.ndarray) -> dict[str, float]:
        """This group's leaf values out of a flat theta vector."""
        vals = np.exp(np.asarray(theta)[self.offset:self.offset + N_LEAVES])
        return dict(zip(LEAF_FIELDS, (float(v) for v in vals)))

    def device_overrides(self, theta: np.ndarray) -> dict[str, float]:
        """The MTJDevice fields of :meth:`leaves` — the kwargs of
        ``mtj.custom_device``."""
        leaves = self.leaves(theta)
        return {f: leaves[f] for f in DEVICE_LEAVES}

    def at_bound(self, theta: np.ndarray, rel_tol: float = 1e-6,
                 ) -> dict[str, str]:
        """Leaves pinned at a bound (active box constraints): leaf name
        -> "lo" / "hi"."""
        out = {}
        for i, f in enumerate(LEAF_FIELDS):
            v = math.exp(float(theta[self.offset + i]))
            if v <= self.lo[i] * (1.0 + rel_tol):
                out[f] = "lo"
            elif v >= self.hi[i] * (1.0 - rel_tol):
                out[f] = "hi"
        return out


def leaf_groups(points) -> tuple[LeafGroup, ...]:
    """One :class:`LeafGroup` per distinct NVM (flavor, node) pair of the
    design points (``(mem, capacity_bytes, node)`` triples or objects
    with ``.mem``/``.node``), in first-appearance order."""
    seen: dict[tuple[str, str], tuple[str, TechNode]] = {}
    for p in points:
        mem, node = (p[0], p[2]) if isinstance(p, tuple) else (p.mem, p.node)
        if mem != "sram" and (mem, node.name) not in seen:
            seen[(mem, node.name)] = (mem, node)
    groups = []
    for offset_idx, (flavor, node) in enumerate(seen.values()):
        centers = leaf_centers(flavor, node)
        lo, hi = [], []
        for f in LEAF_FIELDS:
            span = leaf_span(flavor, f)
            lo.append(centers[f] / span)
            hi.append(centers[f] * span)
        groups.append(LeafGroup(
            flavor=flavor, node=node, offset=offset_idx * N_LEAVES,
            centers=tuple(centers[f] for f in LEAF_FIELDS),
            lo=tuple(lo), hi=tuple(hi)))
    return tuple(groups)


def pack_theta(groups: tuple[LeafGroup, ...]) -> np.ndarray:
    """theta at the centers: ln of every group's anchor values."""
    return np.log(np.concatenate(
        [np.asarray(g.centers, dtype=np.float64) for g in groups]))


def theta_bounds(groups: tuple[LeafGroup, ...],
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of the theta box, in ln space."""
    lo = np.log(np.concatenate(
        [np.asarray(g.lo, dtype=np.float64) for g in groups]))
    hi = np.log(np.concatenate(
        [np.asarray(g.hi, dtype=np.float64) for g in groups]))
    return lo, hi
