"""Unified cross-layer sweep pipeline — one declarative spec for every
analysis.

DeepNVM++'s value is that a single circuit + architecture stack answers
every question — iso-capacity (Figs. 3-5), iso-area (Figs. 6-8),
scalability (Figs. 9-10), and the beyond-paper LM study — from the same
models.  This module makes that literal: a :class:`SweepSpec` declares the
axes of an analysis

    scenarios  (workload, batch, training) TrafficStats — paper CNNs,
               batch sweeps, or LM (arch x shape) cells (repro_torch.scenarios)
    designs    (memory technology, capacity, technology node) points, with
               a normalization group per point (the paper's "normalize to
               SRAM" baseline; cross-node DTCO sweeps group per node)
    platforms  compute platforms (GTX_1080TI, TPU_V5E, ...)

and ``run`` lowers it to **exactly one** circuit-engine call
(``engine.design_table`` over the unique mems x capacities) plus **one**
workload-engine call (``workload_engine.evaluate_platforms`` over the full
[platform] x [scenario] x [design] cross product).  The result is a tidy
:class:`SweepResult` with labeled axes, ``rows()`` (long-format dicts),
``norm_to("sram")`` (the figure convention), ``summary()`` aggregates, and
CSV export.

The per-analysis modules (isocap / isoarea / scaling) and the LM benchmark
are thin adapters that build a spec and materialize their historical row
shapes from the result — no analysis owns its own designs/fold plumbing.

Specs are hashable and ``run`` is memoized, so two analyses that declare
the same axes share one evaluation end to end (the engines memoize their
own layers as well, so partial overlap is also shared).

**Symbolic specs (v2).**  :class:`SymbolicSweepSpec` is the serializable
form of the same declaration: scenarios are names resolved through the
unified registry (``"cnn/resnet18/train@b64"``, ``"lm/qwen3-14b/
decode_32k"`` — repro_torch.scenarios), designs name (mem, capacity, node)
points (``"stt@3MB@10nm"``) or declare grid/corner axes
(:class:`DesignGrid` / :class:`DesignCorners`), and platforms/nodes
resolve via the registries in core/tech.py.  ``to_json``/``from_json``
round-trip a versioned document, and ``resolve()`` lowers the symbolic
spec to a concrete :class:`SweepSpec` — through the same memoized
registry entry points, so a JSON-defined sweep shares the ``run`` memo
(and the one-circuit-call + one-fold-call guarantee) with the equivalent
Python-constructed spec.

Both engines run on the ``device`` every entry point takes (``cuda``
unless the caller passes ``device="cpu"``); the ``run`` memo keys on it.

On the result side, :class:`SweepResult` is a query surface:
``filter()``/``select()`` slice the labeled axes into a
:class:`SweepView`, and ``pareto_front()``/``capacity_plateaus()``
(core/dse.py) reduce multi-capacity sweeps to the non-dominated designs
and the capacity knee per scenario.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
from collections.abc import Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import dse, engine, report, tech, workload_engine
from repro_torch.core import device as device_mod
from repro_torch.core.cachemodel import CacheDesign
from repro_torch.core.tech import Platform, GTX_1080TI, TechNode, TECH_16NM
from repro_torch.core.traffic import TrafficStats
from repro_torch.core.workloads import Workload

MEMS = ("sram", "stt", "sot")
BASELINE_MEM = "sram"

# The IsoCapRow.norm metric vocabulary, shared by rows()/summary().
METRICS = ("dyn", "leak", "energy", "edp", "runtime")
# rows() column name of each raw metric (EDP is J*s, runtime is s).
_ROW_FIELD = {"dyn": "dyn_j", "leak": "leak_j", "energy": "energy_j",
              "edp": "edp_js", "runtime": "runtime_s"}


# ---------------------------------------------------------------------------
# Axis declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One (memory technology, capacity, node) point of the design axis.

    ``group`` labels the normalization group: each group holds exactly one
    baseline-memory design, and ``norm_to`` divides every member by it
    (iso-capacity/iso-area: one group; scaling: one group per capacity;
    DTCO: one group per (node, capacity), so every node is compared against
    its own baseline).
    """

    mem: str
    capacity_bytes: int
    group: object = 0
    node: TechNode = TECH_16NM

    @property
    def capacity_mb(self) -> float:
        return self.capacity_bytes / 2**20


def design_grid(mems: Sequence[str] = MEMS,
                capacities_mb: Sequence[float] = (3,),
                nodes: TechNode | Sequence[TechNode] = (TECH_16NM,),
                ) -> tuple[DesignPoint, ...]:
    """Node-major (node x capacity x memory) cross product, one
    normalization group per (node, capacity) — the iso-capacity, scaling,
    and cross-node DTCO design axes.  Single-node grids keep the bare
    per-capacity group labels (the historical row shape)."""
    nodes = (nodes,) if isinstance(nodes, TechNode) else tuple(nodes)
    single = len(nodes) == 1
    return tuple(DesignPoint(m, int(c * 2**20),
                             group=float(c) if single else (nd.name, float(c)),
                             node=nd)
                 for nd in nodes for c in capacities_mb for m in mems)


def design_corners(points: Sequence[tuple[str, float]],
                   group: object = 0,
                   nodes: TechNode | Sequence[TechNode] = (TECH_16NM,),
                   ) -> tuple[DesignPoint, ...]:
    """Explicit (mem, capacity_mb) corners sharing one normalization group
    — the iso-area design axis (different capacities, one SRAM baseline).

    ``nodes`` replicates the corner set per node (parity with
    ``design_grid``): a single node keeps the bare ``group`` label, several
    nodes label each replica ``(node.name, group)`` so every node
    normalizes against its own baseline corner — the per-node iso-area
    comparison."""
    nodes = (nodes,) if isinstance(nodes, TechNode) else tuple(nodes)
    single = len(nodes) == 1
    return tuple(DesignPoint(m, int(c * 2**20),
                             group=group if single else (nd.name, group),
                             node=nd)
                 for nd in nodes for m, c in points)


def group_label(group: object) -> str:
    """Stable string form of a normalization-group label — the ``group``
    column of ``SweepResult.rows()``/CSV output (floats via %g, tuple
    labels slash-joined; no Python ``repr`` leaks into serialized rows)."""
    if isinstance(group, tuple):
        return "/".join(group_label(g) for g in group)
    if isinstance(group, float):
        return f"{group:g}"
    return str(group)


# ---------------------------------------------------------------------------
# Symbolic design names ("stt@3MB@10nm")
# ---------------------------------------------------------------------------

_DESIGN_NAME_RE = re.compile(
    r"(?P<mem>[a-z0-9_-]+)@(?P<cap>\d+(?:\.\d+)?)MB(?:@(?P<node>[^@]+))?\Z")


def parse_design(name: str) -> tuple[str, float, TechNode]:
    """Parse ``mem@<capacity>MB[@<node>]``; the node defaults to the
    calibrated anchor and otherwise resolves via ``tech.node``."""
    m = _DESIGN_NAME_RE.fullmatch(name)
    if not m:
        raise ValueError(f"bad design name {name!r}: expected "
                         "'mem@<capacity>MB[@<node>]', e.g. 'stt@3MB@10nm'")
    node = tech.node(m.group("node")) if m.group("node") else TECH_16NM
    return m.group("mem"), float(m.group("cap")), node


def design_name(point: DesignPoint, with_node: bool = True) -> str:
    """Symbolic name of a design point (node omitted at the anchor)."""
    name = f"{point.mem}@{point.capacity_mb:g}MB"
    if with_node and point.node != TECH_16NM:
        name += f"@{point.node.name}"
    return name


def _points_from_names(names: Sequence[str]) -> tuple[DesignPoint, ...]:
    """A flat name list resolves with ``design_grid``'s group rule: one
    normalization group per (node, capacity), bare per-capacity labels
    when all points share one node (the historical row shape)."""
    parsed = [parse_design(n) for n in names]
    single = len({node for _, _, node in parsed}) == 1
    return tuple(DesignPoint(m, int(c * 2**20),
                             group=c if single else (nd.name, c),
                             node=nd)
                 for m, c, nd in parsed)


def workload_scenarios(workloads: Mapping[str, Workload] | Iterable[Workload],
                       stages: Sequence[tuple[bool, int]],
                       stage_major: bool = False,
                       ) -> tuple[TrafficStats, ...]:
    """Scenario axis of a (workload x stage) grid, via the shared memoized
    ``workload_engine.stats_for``.  ``stages`` are (training, batch) pairs;
    ``stage_major`` controls the row-major axis (scaling iterates stages
    outermost, iso-capacity/iso-area iterate workloads outermost)."""
    items = tuple(workloads.values() if isinstance(workloads, Mapping)
                  else workloads)
    if stage_major:
        return tuple(workload_engine.stats_for(w, batch, training)
                     for training, batch in stages for w in items)
    return tuple(workload_engine.stats_for(w, batch, training)
                 for w in items for training, batch in stages)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative cross-layer sweep: scenarios x designs x platforms."""

    scenarios: tuple[TrafficStats, ...]
    designs: tuple[DesignPoint, ...]
    platforms: tuple[Platform, ...] = (GTX_1080TI,)
    baseline_mem: str = BASELINE_MEM
    name: str = "sweep"

    def __post_init__(self) -> None:
        if not (self.scenarios and self.designs and self.platforms):
            raise ValueError(f"{self.name}: every axis must be non-empty")
        keys = [(s.workload, s.batch, s.training) for s in self.scenarios]
        if len(set(keys)) != len(keys):
            raise ValueError(f"{self.name}: duplicate scenario keys")
        if len(set(self.designs)) != len(self.designs):
            raise ValueError(f"{self.name}: duplicate design points")

    def run(self, plan: ShardPlan | None = None,
            device="cuda") -> SweepResult:
        return run(self, plan, device)


# ---------------------------------------------------------------------------
# Symbolic SweepSpec v2: serializable, registry-resolved
# ---------------------------------------------------------------------------

SCHEMA = "deepnvm.sweepspec/2"


def _as_tuple(x: object) -> tuple:
    return x if isinstance(x, tuple) else tuple(x)


@dataclasses.dataclass(frozen=True)
class DesignGrid:
    """Symbolic (node x capacity x memory) grid — lowers via
    ``design_grid`` (one normalization group per (node, capacity))."""

    mems: tuple[str, ...] = MEMS
    capacities_mb: tuple[float, ...] = (3,)
    nodes: tuple[str, ...] = ()   # node names; empty = the 16 nm anchor

    def __post_init__(self) -> None:
        object.__setattr__(self, "mems", _as_tuple(self.mems))
        object.__setattr__(self, "capacities_mb",
                           _as_tuple(self.capacities_mb))
        object.__setattr__(self, "nodes", _as_tuple(self.nodes))

    def points(self) -> tuple[DesignPoint, ...]:
        nodes = tuple(tech.node(n) for n in self.nodes) or (TECH_16NM,)
        return design_grid(self.mems, self.capacities_mb, nodes=nodes)

    def to_doc(self) -> dict:
        doc: dict = {"mems": list(self.mems),
                     "capacities_mb": list(self.capacities_mb)}
        if self.nodes:
            doc["nodes"] = list(self.nodes)
        return doc


@dataclasses.dataclass(frozen=True)
class DesignCorners:
    """Symbolic corner set — named (mem, capacity) points sharing one
    normalization group per node, lowered via ``design_corners``.

    Two node forms, mutually exclusive:

      * the ``nodes`` field replicates a node-free corner set per node —
        the same capacities everywhere (iso-capacity across nodes);
      * node-suffixed point names ("stt@8MB@12nm-scaled") place each
        corner on its own node — per-node capacities, as the cross-node
        iso-area study needs (the area budget buys a different capacity
        at every node).  With several distinct nodes each corner joins
        the ``(node.name, group)`` normalization group, so every node
        normalizes against its own baseline corner.
    """

    points: tuple[str, ...]       # "mem@<capacity>MB[@<node>]" names
    group: object = 0
    nodes: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "points", _as_tuple(self.points))
        object.__setattr__(self, "nodes", _as_tuple(self.nodes))
        if isinstance(self.group, list):   # JSON arrays -> hashable labels
            object.__setattr__(self, "group", tuple(self.group))

    def corner_pairs(self) -> tuple[tuple[str, float], ...]:
        pairs = []
        for name in self.points:
            mem, cap, node = parse_design(name)
            if node != TECH_16NM:
                raise ValueError(
                    f"corner {name!r} must not name a node when the "
                    "'nodes' field replicates the set; either drop the "
                    "suffix or leave 'nodes' empty and suffix every "
                    "off-anchor corner")
            pairs.append((mem, cap))
        return tuple(pairs)

    def resolved_points(self) -> tuple[DesignPoint, ...]:
        if self.nodes:
            nodes = tuple(tech.node(n) for n in self.nodes)
            return design_corners(self.corner_pairs(), group=self.group,
                                  nodes=nodes)
        parsed = tuple(parse_design(name) for name in self.points)
        single = len({node for _, _, node in parsed}) == 1
        return tuple(
            DesignPoint(mem, int(cap * 2**20),
                        group=self.group if single
                        else (node.name, self.group),
                        node=node)
            for mem, cap, node in parsed)

    def to_doc(self) -> dict:
        doc: dict = {"points": list(self.points)}
        if self.group != 0:
            doc["group"] = self.group
        if self.nodes:
            doc["nodes"] = list(self.nodes)
        return doc


def _designs_from_doc(doc: object) -> tuple[str, ...] | DesignGrid | DesignCorners:
    if isinstance(doc, Mapping):
        if set(doc) == {"grid"}:
            return DesignGrid(**doc["grid"])
        if set(doc) == {"corners"}:
            return DesignCorners(**doc["corners"])
        raise ValueError(f"bad designs document {sorted(doc)}: expected "
                         "a name list, {'grid': ...}, or {'corners': ...}")
    return _as_tuple(doc)


@dataclasses.dataclass(frozen=True)
class SymbolicSweepSpec:
    """SweepSpec v2: the same scenarios x designs x platforms declaration
    with every axis symbolic — names resolved through registries — and a
    JSON-round-trippable, versioned document form.

    ``resolve()`` lowers to a concrete :class:`SweepSpec` through the
    memoized registry entry points, so an equal symbolic spec (however it
    was constructed — JSON, ``from_spec``, or by hand) resolves to an
    equal concrete spec and therefore shares one memoized ``run`` result.
    """

    scenarios: tuple[str, ...]
    designs: tuple[str, ...] | DesignGrid | DesignCorners
    platforms: tuple[str, ...] = (GTX_1080TI.name,)
    baseline_mem: str = BASELINE_MEM
    name: str = "sweep"

    def __post_init__(self) -> None:
        object.__setattr__(self, "scenarios", _as_tuple(self.scenarios))
        object.__setattr__(self, "platforms", _as_tuple(self.platforms))
        if not isinstance(self.designs, (DesignGrid, DesignCorners)):
            object.__setattr__(self, "designs", _as_tuple(self.designs))

    # -- lowering ----------------------------------------------------------

    def design_points(self) -> tuple[DesignPoint, ...]:
        if isinstance(self.designs, DesignGrid):
            return self.designs.points()
        if isinstance(self.designs, DesignCorners):
            return self.designs.resolved_points()
        return _points_from_names(self.designs)

    def resolve(self) -> SweepSpec:
        """Lower to a concrete spec (today's axes): scenario names through
        the unified registry, design names/grids to DesignPoints, platform
        names through ``tech.PLATFORMS``."""
        # repro_torch.scenarios builds on this module; resolve late to keep the
        # registry layering acyclic.
        from repro_torch import scenarios as scenario_registry
        return SweepSpec(
            name=self.name,
            scenarios=tuple(scenario_registry.resolve(n)
                            for n in self.scenarios),
            designs=self.design_points(),
            platforms=tuple(tech.platform(p) for p in self.platforms),
            baseline_mem=self.baseline_mem)

    def run(self, plan: ShardPlan | None = None,
            device="cuda") -> SweepResult:
        return self.resolve().run(plan, device)

    # -- (de)serialization -------------------------------------------------

    def to_doc(self) -> dict:
        designs: object = list(self.designs) \
            if isinstance(self.designs, tuple) else \
            {"grid": self.designs.to_doc()} \
            if isinstance(self.designs, DesignGrid) else \
            {"corners": self.designs.to_doc()}
        return {"schema": SCHEMA,
                "name": self.name,
                "scenarios": list(self.scenarios),
                "designs": designs,
                "platforms": list(self.platforms),
                "baseline_mem": self.baseline_mem}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_doc(), indent=indent) + "\n"

    @classmethod
    def from_json(cls, doc: str | Mapping) -> SymbolicSweepSpec:
        if not isinstance(doc, Mapping):
            doc = json.loads(doc)
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"unsupported spec schema {doc.get('schema')!r}"
                             f" (this build reads {SCHEMA!r})")
        known = {"schema", "name", "scenarios", "designs", "platforms",
                 "baseline_mem"}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"unknown spec fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        missing = {"scenarios", "designs"} - set(doc)
        if missing:
            raise ValueError(f"spec document lacks {sorted(missing)}")
        return cls(
            scenarios=_as_tuple(doc["scenarios"]),
            designs=_designs_from_doc(doc["designs"]),
            platforms=_as_tuple(doc.get("platforms", (GTX_1080TI.name,))),
            baseline_mem=doc.get("baseline_mem", BASELINE_MEM),
            name=doc.get("name", "sweep"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> SymbolicSweepSpec:
        with open(path) as f:
            return cls.from_json(f.read())

    # -- concrete -> symbolic ----------------------------------------------

    @classmethod
    def from_spec(cls, spec: SweepSpec) -> SymbolicSweepSpec:
        """Symbolize a concrete spec (golden-file generation, serving).
        Scenario names come from the registry's inverse mapping; designs
        become a flat name list when their groups follow the grid rule, a
        corner set when they share one group.  Custom group labelings have
        no symbolic form and raise."""
        from repro_torch import scenarios as scenario_registry
        return cls(
            scenarios=tuple(scenario_registry.name_of(s)
                            for s in spec.scenarios),
            designs=_symbolic_designs(spec.designs),
            platforms=tuple(p.name for p in spec.platforms),
            baseline_mem=spec.baseline_mem,
            name=spec.name)


def _symbolic_designs(points: Sequence[DesignPoint],
                      ) -> tuple[str, ...] | DesignCorners:
    single = len({p.node for p in points}) == 1
    def grid_group(p: DesignPoint) -> object:
        return float(p.capacity_mb) if single \
            else (p.node.name, float(p.capacity_mb))
    if all(p.group == grid_group(p) for p in points):
        return tuple(design_name(p) for p in points)
    groups = {p.group for p in points}
    if single and len(groups) == 1:
        node = points[0].node
        return DesignCorners(
            points=tuple(design_name(p, with_node=False) for p in points),
            group=next(iter(groups)),
            nodes=() if node == TECH_16NM else (node.name,))
    # multi-node corner sets: per-point (node.name, G) groups sharing one G
    # symbolize as node-suffixed corner names (the cross-node iso-area form)
    shared = {g[1] for g in groups if isinstance(g, tuple) and len(g) == 2}
    if not single and len(shared) == 1:
        g = next(iter(shared))
        if all(p.group == (p.node.name, g) for p in points):
            return DesignCorners(
                points=tuple(design_name(p) for p in points), group=g)
    raise ValueError("designs with custom normalization groups have no "
                     "symbolic form; serialize grid- or corner-shaped axes")


def load_spec(path: str) -> SymbolicSweepSpec:
    """Module-level convenience: read a spec JSON document."""
    return SymbolicSweepSpec.load(path)


# ---------------------------------------------------------------------------
# Lowering: spec -> one circuit call + one workload-fold call
# ---------------------------------------------------------------------------


def lower_designs(points: Sequence[DesignPoint], pad_caps: bool = False,
                  device="cuda",
                  ) -> tuple[engine.DesignTable, tuple[CacheDesign, ...]]:
    """One memoized ``engine.design_table`` over the unique nodes, mems,
    and capacities, then the EDAP-tuned design of every point (Algorithm 1,
    memoized per (node, mem, capacity) on the table).

    ``pad_caps`` pads the capacity axis to its power-of-two bucket with
    deterministic dummy capacities before the circuit call and slices the
    table back to the real axis after tuning, so the PPA equations only
    ever run at O(log) capacity counts — the sweep service's warmup-able
    path.  Tuning is a per-(node, mem, capacity) argmin over the
    organization axis, so the tuned designs are the unpadded ones; only
    the tensors' *shape* changes.  The tables are those of ``device``."""
    nodes = tuple(dict.fromkeys(p.node for p in points))
    mems = tuple(dict.fromkeys(p.mem for p in points))
    caps = tuple(dict.fromkeys(p.capacity_bytes for p in points))
    lowered = _pad_capacities(caps) if pad_caps else caps
    table = engine.design_table(mems, lowered, nodes=nodes, device=device)
    designs = tuple(table.tuned(p.mem, p.capacity_bytes, node=p.node)
                    for p in points)
    if lowered is not caps:
        # drop the dummy columns; Algorithm-1 winners carry over
        table = table.subset(capacities_bytes=caps)
    return table, designs


def _pad_capacities(caps: tuple[int, ...]) -> tuple[int, ...]:
    """Pad a unique-capacity tuple to its power-of-two bucket with dummy
    capacities just above the real maximum (64-byte steps, skipping any
    collision with a real value) — deterministic, so the padded tuple and
    therefore the ``engine.design_table`` memo key are stable per real
    capacity set."""
    target = workload_engine.axis_bucket(len(caps))
    if target == len(caps):
        return caps
    used = set(caps)
    pad: list[int] = []
    c = max(caps)
    while len(caps) + len(pad) < target:
        c += 64
        if c not in used:
            pad.append(c)
            used.add(c)
    return caps + tuple(pad)


@functools.lru_cache(maxsize=None)
def _run_cached(spec: SweepSpec, device: str) -> SweepResult:
    table, designs = lower_designs(spec.designs, device=device)
    tables = workload_engine.evaluate_platforms(spec.scenarios, designs,
                                                spec.platforms, device)
    return SweepResult(spec=spec, design_table=table, designs=designs,
                       tables=tables)


def run(spec: SweepSpec, plan: ShardPlan | None = None,
        device="cuda") -> SweepResult:
    """Lower and evaluate a spec on ``device``.

    Without a plan: exactly one ``engine.design_table`` call plus one
    ``workload_engine.evaluate_platforms`` call, memoized per (spec,
    device) so equal specs share one SweepResult object.

    With a :class:`ShardPlan`: the chunked/sharded lowering —
    ``run_sharded(spec, plan)`` — which streams partial results through
    ``SweepResult.merge`` instead of materializing one mega-tensor (and
    is deliberately *not* memoized: mega-results are too large to pin)."""
    if plan is not None:
        return run_sharded(spec, plan, device=device)
    return _run_cached(spec, device_mod.resolve(device))


def n_cells(spec: SweepSpec) -> int:
    """Evaluated cells of a spec: platforms x scenarios x designs."""
    return len(spec.platforms) * len(spec.scenarios) * len(spec.designs)


def clear_cache() -> None:
    """Drop memoized sweep results (benchmark reruns; the engine-layer
    caches are cleared separately via their own hooks)."""
    _run_cached.cache_clear()


# ---------------------------------------------------------------------------
# Sharded lowering: ShardPlan -> chunks -> streaming merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How to split a sweep into independently evaluated chunks.

    ``scenario_chunk`` / ``design_chunk`` bound the chunk extent along
    each axis (None = don't split that axis).  ``devices`` = 1 folds each
    chunk as a one-chunk stacked group (``evaluate_chunk_group``, the
    reference's per-device shard_map body); None folds each chunk with
    ``evaluate_chunk``.  The port runs a sweep on one device, so any other
    count raises when the plan is run.  ``by_width`` orders scenarios by stream count before
    chunking, so wide outliers (googlenet train: 645 streams) share chunks
    and the padded-SoA area of the stream tensors stays near-minimal.
    """

    scenario_chunk: int | None = None
    design_chunk: int | None = None
    devices: int | None = None
    by_width: bool = False

    def __post_init__(self) -> None:
        for field in ("scenario_chunk", "design_chunk", "devices"):
            v = getattr(self, field)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{field} must be a positive int or None,"
                                 f" got {v!r}")


def split(spec: SweepSpec, plan: ShardPlan) -> tuple[SweepSpec, ...]:
    """Split a spec into the plan's grid of sub-specs: every (scenario
    block) x (design block) becomes one independent chunk spec sharing the
    parent's platforms and baseline.  The union of chunk cells tiles the
    parent's cross product exactly once (``SweepResult.merge`` validates
    this on reassembly)."""
    sc = plan.scenario_chunk or len(spec.scenarios)
    dc = plan.design_chunk or len(spec.designs)
    s_order = sorted(range(len(spec.scenarios)),
                     key=lambda i: -len(spec.scenarios[i].streams)) \
        if plan.by_width else list(range(len(spec.scenarios)))
    s_blocks = [tuple(s_order[i:i + sc])
                for i in range(0, len(s_order), sc)]
    d_blocks = [tuple(range(j, min(j + dc, len(spec.designs))))
                for j in range(0, len(spec.designs), dc)]
    return tuple(
        SweepSpec(name=f"{spec.name}#{si}.{di}",
                  scenarios=tuple(spec.scenarios[i] for i in s_block),
                  designs=tuple(spec.designs[j] for j in d_block),
                  platforms=spec.platforms,
                  baseline_mem=spec.baseline_mem)
        for si, s_block in enumerate(s_blocks)
        for di, d_block in enumerate(d_blocks))


def _chunk_result(sub: SweepSpec, table: engine.DesignTable,
                  design_of: Mapping[DesignPoint, CacheDesign], device: str,
                  tables: tuple[workload_engine.WorkloadTable, ...] | None
                  = None) -> SweepResult:
    designs = tuple(design_of[p] for p in sub.designs)
    if tables is None:
        tables = workload_engine.evaluate_chunk(sub.scenarios, designs,
                                                sub.platforms, device=device)
    sub_table = table.subset(
        mems=tuple(dict.fromkeys(p.mem for p in sub.designs)),
        capacities_bytes=tuple(dict.fromkeys(p.capacity_bytes
                                             for p in sub.designs)),
        nodes=tuple(dict.fromkeys(p.node for p in sub.designs)))
    return SweepResult(spec=sub, design_table=sub_table, designs=designs,
                       tables=tables)


def iter_shards(spec: SweepSpec, plan: ShardPlan, device="cuda"):
    """Evaluate a spec chunk by chunk, yielding one partial SweepResult
    per chunk — the streaming form of ``run_sharded``.

    The circuit layer is lowered **once** up front (one memoized
    ``engine.design_table`` + Algorithm-1 tuning over the full design
    axis); each chunk then folds its own scenarios x designs block through
    an uncached, chunk-packed ``workload_engine`` call, so peak memory is
    bounded by one chunk's stream tensors plus the partial results.  With
    ``plan.devices`` = 1 each chunk folds as a one-chunk stacked group;
    any other device count raises, naming the CUDA devices found.
    """
    if plan.devices not in (None, 1):
        raise ValueError(
            f"ShardPlan(devices={plan.devices}): the port runs a sweep on "
            f"one device (found {torch.cuda.device_count()} CUDA "
            "device(s)); use devices=None or devices=1")
    device = device_mod.resolve(device)
    table, designs = lower_designs(spec.designs, device=device)
    design_of = dict(zip(spec.designs, designs))
    for sub in split(spec, plan):
        tables = None
        if plan.devices == 1:
            (tables,) = workload_engine.evaluate_chunk_group(
                [sub.scenarios], [[design_of[p] for p in sub.designs]],
                spec.platforms, device)
        yield _chunk_result(sub, table, design_of, device, tables)


def run_sharded(spec: SweepSpec, plan: ShardPlan,
                progress=None, device="cuda") -> SweepResult:
    """Chunked/sharded evaluation: stream every chunk of ``split(spec,
    plan)`` through the order-invariant merge.  ``progress(i, total,
    part)`` is called per completed chunk (the CLI's stderr ticker).
    Merged output is pinned to the unsharded path at <= 1e-12 (chunk
    packing may pad reductions differently, so the last ulps can move)."""
    total = len(split(spec, plan))

    def parts():
        for i, part in enumerate(iter_shards(spec, plan, device)):
            if progress is not None:
                progress(i + 1, total, part)
            yield part

    return merge_results(parts(), spec=spec, device=device)


# -- merge: order-invariant reassembly of partial results -------------------

_SHARED_S = ("l2_read_tx", "l2_write_tx")
_SHARED_SD = ("dram_tx", "dyn_read_j", "dyn_write_j")


def _scenario_key(stats: TrafficStats) -> tuple[str, int, bool]:
    return (stats.workload, stats.batch, stats.training)


def _design_sort_key(p: DesignPoint):
    return (p.mem, p.capacity_bytes, p.node.name, group_label(p.group))


def merge_results(parts: Iterable[SweepResult],
                  spec: SweepSpec | None = None,
                  device="cuda") -> SweepResult:
    """Reassemble partial SweepResults into one result.

    The parts' (scenario x design) blocks must tile the merged cross
    product exactly — overlapping cells raise immediately, missing cells
    raise at the end — and all parts must agree on platforms and baseline.
    With ``spec``, axes follow the spec's order and parts are **streamed**
    into preallocated tensors (consumed-and-dropped, the bounded-memory
    path ``run_sharded`` uses); without it, parts are collected first and
    the merged axes take a canonical sorted order, which is what makes the
    merge order-invariant and associative (any grouping of parts whose
    intermediate unions stay rectangular merges to the identical result).
    The merged result's design table is the memoized one of ``device``.
    """
    if spec is None:
        parts = list(parts)
        if not parts:
            raise ValueError("merge needs at least one partial result")
        scen_of: dict[tuple, TrafficStats] = {}
        points: set[DesignPoint] = set()
        for part in parts:
            for s in part.spec.scenarios:
                scen_of.setdefault(_scenario_key(s), s)
            points.update(part.spec.designs)
        spec = SweepSpec(
            name=parts[0].spec.name.partition("#")[0],
            scenarios=tuple(scen_of[k] for k in sorted(scen_of)),
            designs=tuple(sorted(points, key=_design_sort_key)),
            platforms=parts[0].spec.platforms,
            baseline_mem=parts[0].spec.baseline_mem)
    s_index = {_scenario_key(s): i for i, s in enumerate(spec.scenarios)}
    d_index = {p: j for j, p in enumerate(spec.designs)}
    n_p, n_s, n_d = (len(spec.platforms), len(spec.scenarios),
                     len(spec.designs))
    cov = np.zeros((n_s, n_d), dtype=np.int8)
    shared_s = {f: np.zeros(n_s) for f in _SHARED_S}
    shared_sd = {f: np.zeros((n_s, n_d)) for f in _SHARED_SD}
    platdep = {f: np.zeros((n_p, n_s, n_d))
               for f in workload_engine._PLATFORM_DEPENDENT}
    designs: list[CacheDesign | None] = [None] * n_d
    got_any = False
    for part in parts:
        got_any = True
        if part.spec.platforms != spec.platforms:
            raise ValueError(
                f"chunk {part.spec.name!r} platforms differ from the "
                "merge target's")
        if part.spec.baseline_mem != spec.baseline_mem:
            raise ValueError(
                f"chunk {part.spec.name!r} baseline_mem differs from the "
                "merge target's")
        try:
            srows = [s_index[k] for k in part.scenario_labels]
            dcols = [d_index[p] for p in part.spec.designs]
        except KeyError as e:
            raise ValueError(f"chunk {part.spec.name!r} carries an axis "
                             f"label outside the merge target: {e}") \
                from None
        block = np.ix_(srows, dcols)
        if cov[block].any():
            raise ValueError(
                f"overlapping chunks: {part.spec.name!r} re-covers "
                "already-merged (scenario, design) cells")
        cov[block] = 1
        for j, d in zip(dcols, part.designs):
            designs[j] = d
        t0 = part.tables[0]
        for f in _SHARED_S:
            shared_s[f][srows] = getattr(t0, f)
        for f in _SHARED_SD:
            shared_sd[f][block] = getattr(t0, f)
        for pi in range(n_p):
            for f in workload_engine._PLATFORM_DEPENDENT:
                platdep[f][pi][block] = getattr(part.tables[pi], f)
    if not got_any:
        raise ValueError("merge needs at least one partial result")
    if not cov.all():
        missing = int((cov == 0).sum())
        raise ValueError(
            f"merged chunks do not tile the sweep: {missing} of "
            f"{n_s * n_d} (scenario, design) cells uncovered")
    table, _ = lower_designs(spec.designs, device=device)
    keys = tuple(_scenario_key(s) for s in spec.scenarios)
    tables = tuple(
        workload_engine.WorkloadTable(
            scenarios=keys, designs=tuple(designs), platform=p,
            **shared_s, **shared_sd,
            **{f: platdep[f][pi]
               for f in workload_engine._PLATFORM_DEPENDENT})
        for pi, p in enumerate(spec.platforms))
    return SweepResult(spec=spec, design_table=table,
                       designs=tuple(designs), tables=tables)


# -- union: superset spec of compatible requests (service coalescing) -------


def spec_union(specs: Sequence[SweepSpec], name: str | None = None,
               ) -> SweepSpec:
    """The smallest spec covering every member — the coalescing superset
    the concurrent sweep service evaluates once and slices per-request
    views out of (``SweepResult.subset``, the inverse of ``merge``).

    Compatibility rule: every member must declare the identical platform
    axis (same platforms, same order) — platform count changes the fold's
    shape and a mismatched axis cannot share one evaluation.
    Scenario axes union by (workload, batch, training) key and design axes
    by DesignPoint identity (which includes the normalization group, so
    the same (mem, capacity, node) under two groupings stays two columns),
    both in first-seen order.  ``baseline_mem`` need *not* agree: each
    request's subset result carries the request's own spec, so
    normalization happens per request, never on the union.
    """
    specs = tuple(specs)
    if not specs:
        raise ValueError("spec_union needs at least one spec")
    first = specs[0]
    for sp in specs[1:]:
        if sp.platforms != first.platforms:
            raise ValueError(
                f"incompatible specs: {sp.name!r} declares a different "
                f"platform axis than {first.name!r}")
    if len(specs) == 1:
        return first
    scen: dict[tuple, TrafficStats] = {}
    points: dict[DesignPoint, None] = {}
    for sp in specs:
        for s in sp.scenarios:
            scen.setdefault(_scenario_key(s), s)
        for p in sp.designs:
            points.setdefault(p)
    return SweepSpec(
        name=name if name is not None else f"union[{len(specs)}]",
        scenarios=tuple(scen.values()),
        designs=tuple(points),
        platforms=first.platforms,
        baseline_mem=first.baseline_mem)


# ---------------------------------------------------------------------------
# Result: labeled axes + tidy views
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SweepResult:
    """Evaluated sweep: [platform] x [scenario] x [design] tensors.

    ``tables[i]`` is the WorkloadTable view of platform i (one shared
    kernel evaluation); ``design_table`` is the circuit-engine sweep the
    designs were tuned from.
    """

    spec: SweepSpec
    design_table: engine.DesignTable
    designs: tuple[CacheDesign, ...]
    tables: tuple[workload_engine.WorkloadTable, ...]

    @classmethod
    def merge(cls, parts: Iterable[SweepResult],
              spec: SweepSpec | None = None,
              device="cuda") -> SweepResult:
        """Order-invariant reassembly of disjoint partial results — see
        :func:`merge_results`."""
        return merge_results(parts, spec=spec, device=device)

    def subset(self, spec: SweepSpec) -> SweepResult:
        """Slice this result down to a member spec — the inverse of
        ``merge`` and the per-request view of a coalesced superset
        evaluation (:func:`spec_union`).

        Every scenario key, design point, and platform of ``spec`` must be
        present in this result (axes may reorder).  The returned result
        carries ``spec`` itself — including its own ``baseline_mem`` and
        normalization groups — so ``rows()``/``summary()`` match an
        individual evaluation of ``spec``; no metric is recomputed, only
        sliced."""
        s_index = {k: i for i, k in enumerate(self.scenario_labels)}
        d_index = {p: j for j, p in enumerate(self.spec.designs)}
        p_index = {p: i for i, p in enumerate(self.spec.platforms)}
        try:
            srows = [s_index[_scenario_key(s)] for s in spec.scenarios]
            dcols = [d_index[p] for p in spec.designs]
            prows = [p_index[p] for p in spec.platforms]
        except KeyError as e:
            raise ValueError(f"subset spec {spec.name!r} has an axis label "
                             f"outside this result: {e}") from None
        block = np.ix_(srows, dcols)
        keys = tuple(_scenario_key(s) for s in spec.scenarios)
        designs = tuple(self.designs[j] for j in dcols)
        sd_fields = _SHARED_SD + workload_engine._PLATFORM_DEPENDENT
        tables = tuple(
            workload_engine.WorkloadTable(
                scenarios=keys, designs=designs,
                platform=self.spec.platforms[pi],
                **{f: getattr(self.tables[pi], f)[srows]
                   for f in _SHARED_S},
                **{f: getattr(self.tables[pi], f)[block]
                   for f in sd_fields})
            for pi in prows)
        table = self.design_table.subset(
            mems=tuple(dict.fromkeys(p.mem for p in spec.designs)),
            capacities_bytes=tuple(dict.fromkeys(p.capacity_bytes
                                                 for p in spec.designs)),
            nodes=tuple(dict.fromkeys(p.node for p in spec.designs)))
        return SweepResult(spec=spec, design_table=table, designs=designs,
                           tables=tables)

    # -- labeled axes ------------------------------------------------------

    @property
    def scenario_labels(self) -> tuple[tuple[str, int, bool], ...]:
        """(workload, batch, training) per scenario row."""
        return self.tables[0].scenarios

    @property
    def design_labels(self) -> tuple[tuple[str, float, str], ...]:
        """(mem, capacity_mb, node_name) per design column."""
        return tuple((p.mem, p.capacity_mb, p.node.name)
                     for p in self.spec.designs)

    @property
    def platform_labels(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.spec.platforms)

    @property
    def axes(self) -> dict[str, tuple]:
        return {"platform": self.platform_labels,
                "scenario": self.scenario_labels,
                "design": self.design_labels}

    def design_index(self, mem: str, capacity_mb: float | None = None,
                     node: TechNode | str | None = None) -> int:
        node_name = node.name if isinstance(node, TechNode) else node
        matches = [j for j, p in enumerate(self.spec.designs)
                   if p.mem == mem
                   and capacity_mb in (None, p.capacity_mb)
                   and node_name in (None, p.node.name)]
        if not matches:
            raise ValueError(
                f"no design ({mem}, {capacity_mb}, {node_name}) in sweep")
        if len(matches) > 1:
            raise ValueError(
                f"ambiguous design ({mem}, {capacity_mb}, {node_name})")
        return matches[0]

    # -- metric tensors ----------------------------------------------------

    def metric(self, name: str, include_dram: bool = False) -> np.ndarray:
        """[p, s, d] tensor of one METRICS entry."""
        return np.stack([t.metric(name, include_dram) for t in self.tables])

    @property
    def dram_tx(self) -> np.ndarray:
        """[s, d] DRAM transactions (platform-independent)."""
        return self.tables[0].dram_tx

    @property
    def read_write_ratio(self) -> np.ndarray:
        """[s] L2 read/write transaction ratio (platform-independent)."""
        return self.tables[0].read_write_ratio

    # -- normalization (the paper's figure convention) ---------------------

    def baseline_indices(self, baseline_mem: str | None = None) -> np.ndarray:
        """[d] index of each design's normalization baseline: the unique
        baseline-memory design of its group."""
        base = baseline_mem if baseline_mem is not None \
            else self.spec.baseline_mem
        by_group: dict[object, int] = {}
        for j, p in enumerate(self.spec.designs):
            if p.mem == base:
                if p.group in by_group:
                    raise ValueError(
                        f"group {p.group!r} has several {base!r} designs")
                by_group[p.group] = j
        missing = {p.group for p in self.spec.designs} - set(by_group)
        if missing:
            raise ValueError(f"groups {sorted(map(repr, missing))} have no "
                             f"{base!r} baseline design")
        return np.array([by_group[p.group] for p in self.spec.designs])

    def norm_to(self, baseline_mem: str | None = None) -> NormalizedSweep:
        """Metrics normalized to the baseline design of each group."""
        return NormalizedSweep(self, self.baseline_indices(baseline_mem))

    # -- labeled-axis attributes (rows()/filter()/dse vocabulary) ----------

    def scenario_attrs(self, i: int) -> dict:
        workload, batch, training = self.scenario_labels[i]
        return dict(workload=workload, batch=batch,
                    stage="train" if training else "infer")

    def design_attrs(self, j: int) -> dict:
        p = self.spec.designs[j]
        return dict(mem=p.mem, capacity_mb=p.capacity_mb, node=p.node.name,
                    group=group_label(p.group))

    # -- query surface -----------------------------------------------------

    def view(self) -> SweepView:
        """The whole result as a filterable view."""
        return SweepView(self,
                         tuple(range(len(self.platform_labels))),
                         tuple(range(len(self.scenario_labels))),
                         tuple(range(len(self.spec.designs))))

    def filter(self, **criteria) -> SweepView:
        """Select by labeled-axis attributes — ``platform``, scenario keys
        (``workload``/``batch``/``stage``/``training``), design keys
        (``mem``/``capacity_mb``/``node``/``group``).  A criterion is a
        scalar, a collection (membership), or a predicate."""
        return self.view().filter(**criteria)

    def select(self, *fields: str, include_dram: bool = False) -> list[tuple]:
        return self.view().select(*fields, include_dram=include_dram)

    # -- DSE reductions (core/dse.py) --------------------------------------

    def pareto_front(self, objectives: Sequence[str] = dse.DEFAULT_OBJECTIVES,
                     include_dram: bool = False) -> list[dict]:
        """Per-(platform, scenario) non-dominated designs over the given
        minimize-objectives (default energy/runtime/area)."""
        return dse.pareto_front(self, objectives, include_dram)

    def capacity_plateaus(self, metric: str = "edp",
                          include_dram: bool = True,
                          rel_tol: float = 0.05) -> list[dict]:
        """Per-(platform, scenario, mem, node) capacity knee: the smallest
        capacity within ``rel_tol`` of the best over the capacity axis."""
        return dse.capacity_plateaus(self, metric, include_dram, rel_tol)

    # -- tidy materialization ----------------------------------------------

    def rows(self, include_norm: bool = True,
             include_dram: bool = False) -> list[dict]:
        """Long-format rows: one dict per (platform, scenario, design)."""
        return self.view().rows(include_norm, include_dram)

    def summary(self, include_dram: bool = True) -> dict:
        """Per-(platform, non-baseline mem) aggregate reductions over all
        scenarios and design groups (the §IV prose-claim shape)."""
        norm = self.norm_to()
        energy = norm.metric("energy", include_dram=False)
        edp = norm.metric("edp", include_dram=include_dram)
        dyn = norm.metric("dyn")
        leak = norm.metric("leak")
        base = self.baseline_indices()
        out: dict[str, dict[str, dict[str, float]]] = {}
        for pi, platform in enumerate(self.platform_labels):
            per_mem: dict[str, dict[str, float]] = {}
            for mem in dict.fromkeys(p.mem for p in self.spec.designs):
                if mem == self.spec.baseline_mem:
                    continue
                cols = [j for j, p in enumerate(self.spec.designs)
                        if p.mem == mem and base[j] != j]
                if not cols:
                    continue
                per_mem[mem] = dict(
                    dyn_energy_x=float(dyn[pi][:, cols].mean()),
                    leak_reduction=float((1.0 / leak[pi][:, cols]).mean()),
                    energy_reduction=float(
                        (1.0 / energy[pi][:, cols]).mean()),
                    edp_reduction_mean=float((1.0 / edp[pi][:, cols]).mean()),
                    edp_reduction_max=float((1.0 / edp[pi][:, cols]).max()),
                )
            out[platform] = per_mem
        return out

    def to_csv(self, path: str, include_norm: bool = True,
               include_dram: bool = False, exact: bool = False) -> None:
        """Write rows as CSV.  ``exact`` keeps full float precision (repr
        round-trip — the CLI's bit-for-bit reproduction mode) instead of
        the human-readable rounding."""
        report.write_csv(path, self.rows(include_norm, include_dram),
                         fmt=report.fmt_exact if exact else None)


@dataclasses.dataclass(frozen=True, eq=False)
class NormalizedSweep:
    """View of a SweepResult with every metric divided by its group's
    baseline design (elementwise, the scalar IsoCapRow.norm convention)."""

    result: SweepResult
    baseline: np.ndarray  # [d] baseline design index per design

    def metric(self, name: str, include_dram: bool = False) -> np.ndarray:
        m = self.result.metric(name, include_dram)
        return m / m[:, :, self.baseline]


# ---------------------------------------------------------------------------
# SweepView: filter/select on labeled axes
# ---------------------------------------------------------------------------


def _match(criterion: object, value: object) -> bool:
    if callable(criterion):
        return bool(criterion(value))
    if isinstance(criterion, (list, tuple, set, frozenset)):
        return value in criterion
    return value == criterion


_SCENARIO_KEYS = ("workload", "batch", "stage", "training")
_DESIGN_KEYS = ("mem", "capacity_mb", "node", "group")


@dataclasses.dataclass(frozen=True, eq=False)
class SweepView:
    """Index selection on a SweepResult's [platform, scenario, design]
    axes — the query layer ``filter()`` chains on.  Metric tensors are
    sliced from the shared result (nothing is re-evaluated); ``rows()``
    normalization baselines stay those of the *full* result, so a filtered
    view reports the same normalized values as the full row set."""

    result: SweepResult
    platform_ids: tuple[int, ...]
    scenario_ids: tuple[int, ...]
    design_ids: tuple[int, ...]

    def __len__(self) -> int:
        return (len(self.platform_ids) * len(self.scenario_ids)
                * len(self.design_ids))

    # -- filtering ---------------------------------------------------------

    def filter(self, **criteria) -> SweepView:
        known = ("platform",) + _SCENARIO_KEYS + _DESIGN_KEYS
        unknown = set(criteria) - set(known)
        if unknown:
            raise ValueError(f"unknown filter keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        r = self.result
        p_ids = tuple(i for i in self.platform_ids
                      if "platform" not in criteria
                      or _match(criteria["platform"], r.platform_labels[i]))
        s_ids = tuple(i for i in self.scenario_ids
                      if self._scenario_ok(i, criteria))
        d_ids = tuple(j for j in self.design_ids
                      if self._design_ok(j, criteria))
        return SweepView(r, p_ids, s_ids, d_ids)

    def _scenario_ok(self, i: int, criteria: Mapping) -> bool:
        attrs = self.result.scenario_attrs(i)
        attrs["training"] = attrs["stage"] == "train"
        return all(_match(criteria[k], attrs[k])
                   for k in _SCENARIO_KEYS if k in criteria)

    def _design_ok(self, j: int, criteria: Mapping) -> bool:
        point = self.result.spec.designs[j]
        for key in _DESIGN_KEYS:
            if key not in criteria:
                continue
            crit = criteria[key]
            if key == "node":
                crit = crit.name if isinstance(crit, TechNode) else crit
                ok = _match(crit, point.node.name)
            elif key == "group":
                # raw group objects and their stable labels both match; a
                # criterion equal to the raw group compares directly, so
                # tuple groups (DTCO) don't read as membership collections
                ok = crit == point.group or _match(crit, point.group) \
                    or _match(crit, group_label(point.group))
            else:
                ok = _match(crit, getattr(point, key))
            if not ok:
                return False
        return True

    # -- materialization ---------------------------------------------------

    def metric(self, name: str, include_dram: bool = False) -> np.ndarray:
        """[p', s', d'] slice of one METRICS tensor."""
        m = self.result.metric(name, include_dram)
        return m[np.ix_(self.platform_ids, self.scenario_ids,
                        self.design_ids)]

    def rows(self, include_norm: bool = True,
             include_dram: bool = False) -> list[dict]:
        r = self.result
        m = {name: r.metric(name, include_dram) for name in METRICS}
        x = {name: r.norm_to().metric(name, include_dram)
             for name in METRICS} if include_norm else {}
        out = []
        for pi in self.platform_ids:
            for si in self.scenario_ids:
                for di in self.design_ids:
                    row = dict(platform=r.platform_labels[pi],
                               **r.scenario_attrs(si),
                               **r.design_attrs(di))
                    row.update({_ROW_FIELD[k]: float(v[pi, si, di])
                                for k, v in m.items()})
                    row.update({f"{k}_x": float(v[pi, si, di])
                                for k, v in x.items()})
                    out.append(row)
        return out

    def select(self, *fields: str, include_dram: bool = False) -> list[tuple]:
        """Project rows onto the named columns (raw metric columns,
        ``*_x`` normalized columns, or axis labels)."""
        needs_norm = any(f.endswith("_x") for f in fields)
        rows = self.rows(include_norm=needs_norm, include_dram=include_dram)
        if rows and (bad := set(fields) - set(rows[0])):
            raise ValueError(f"unknown columns {sorted(bad)}; available: "
                             f"{sorted(rows[0])}")
        return [tuple(r[f] for f in fields) for r in rows]
