"""Scenario registry — one symbolic namespace for every workload the
pipeline can fold.

The paper's CNN workloads enter the pipeline through the traffic model
(``workload_engine.stats_for``); this module is the same entry point for
the assigned LM architectures: every ``repro_torch.configs`` architecture x
{train_4k, prefill_32k, decode_32k, long_500k} shape becomes a packed
:class:`~repro_torch.core.traffic.TrafficStats` built from the analytic byte
accounting the roofline uses (``launch/flops.py``), so the whole LM study
runs as one batched [arch-shape] x [mem, capacity] x [platform] fold on
the workload engine.

Both scenario kinds live under one namespace, resolved by :func:`resolve`
(the symbolic SweepSpec v2 scenario axis, core/sweep.py):

    cnn/<workload>/<stage>@b<batch>   e.g. "cnn/resnet18/train@b64"
    lm/<arch>/<shape>[@b<batch>]      e.g. "lm/qwen3-14b/decode_32k@b8"

The LM ``@b<n>`` suffix overrides the shape's default global batch
(``configs.base.SHAPES``), so serving-fleet batch mixes sweep as
first-class scenario cells; the bare name keeps the registered default
batch (the historical LM-study rows are unchanged).

``name_of`` is the inverse (used to serialize concrete specs), and a
heterogeneous spec may mix both kinds on one scenario axis — they fold in
a single batched evaluation.

``long_500k`` (524k-token decode) is only meaningful for sub-quadratic
architectures (SSM / hybrid / linear attention); ``lm_supported`` encodes
that guard and ``lm_scenarios`` applies it, so quadratic-attention archs
simply have no row for that shape.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES
from repro_torch.core import sweep, workload_engine, workloads
from repro_torch.core.tech import Platform, TechNode, TECH_16NM, TPU_V5E
from repro_torch.core.traffic import INF, AccessStream, TrafficStats
from repro_torch.launch import flops as flops_mod

# The LM study's shape axis, in row order.  long_500k rows exist only for
# sub-quadratic architectures (see lm_supported).
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
LM_CAPACITY_MB = 48  # TPU-class last-level on-chip buffer (VMEM regime)
# Registered batch overrides of the LM namespace (``@b<n>``) — the
# serving-fleet batch mix axis exposed through names()/the sweep service.
LM_BATCHES = (1, 8, 32)


@functools.lru_cache(maxsize=None)
def lm_traffic(arch: str, shape_name: str,
               batch: int | None = None) -> TrafficStats:
    """AccessStreams of one step of an (arch x shape) cell, from the same
    analytic model the roofline uses.  Memoized: scenarios are shared
    across sweeps the same way ``workload_engine.stats_for`` shares the
    paper workloads.  ``batch`` overrides the shape's default global
    batch; the scenario's workload key then carries an ``@b<n>`` suffix
    so ``name_of`` stays the inverse of ``resolve`` and the cell never
    collides with the default-batch one on a scenario axis."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    key = f"{arch}/{shape_name}"
    if batch is not None:
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"LM batch override must be a positive int, "
                             f"got {batch!r}")
        shape = dataclasses.replace(shape, global_batch=batch)
        key += f"@b{batch}"
    acct = flops_mod.account(cfg, shape)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    d = cfg.d_model
    streams = [
        AccessStream("weights", acct.param_bytes, False, INF),
        AccessStream("activations.r",
                     12.0 * tokens * d * 2.0, False, 4 * tokens * d // 64),
        AccessStream("activations.w",
                     6.0 * tokens * d * 2.0, True, 4 * tokens * d // 64),
        AccessStream("kv.r", acct.kv_read_bytes, False, INF),
        AccessStream("kv.w", acct.kv_write_bytes, True, INF),
        AccessStream("logits", tokens * cfg.vocab * 4.0, True, INF),
    ]
    if shape.kind == "train":
        streams += [
            AccessStream("grads.w", acct.param_bytes, True, INF),
            AccessStream("opt.r", 3.0 * acct.param_bytes, False, INF),
            AccessStream("opt.w", 2.0 * acct.param_bytes, True, INF),
        ]
    # KV-less cells (e.g. training) must not emit zero-byte streams: they
    # would pollute the packed fold with degenerate entries
    streams = [s for s in streams if s.bytes_total > 0]
    return TrafficStats(key, shape.global_batch,
                        shape.kind == "train", tuple(streams),
                        macs_per_batch=acct.flops / 2.0)


def lm_supported(arch: str, shape_name: str) -> bool:
    """Whether an (arch, shape) cell exists: long_500k needs a
    sub-quadratic architecture."""
    return shape_name != "long_500k" or configs.get(arch).sub_quadratic


def lm_scenarios(archs: Sequence[str] | None = None,
                 shapes: Sequence[str] = LM_SHAPES,
                 ) -> tuple[TrafficStats, ...]:
    """Scenario axis of the LM study: arch-major over every supported
    (arch x shape) cell."""
    archs = tuple(archs) if archs is not None else configs.all_archs()
    return tuple(lm_traffic(a, s) for a in archs for s in shapes
                 if lm_supported(a, s))


# ---------------------------------------------------------------------------
# The unified symbolic namespace (SweepSpec v2 scenario axis)
# ---------------------------------------------------------------------------

_STAGES = {"train": True, "infer": False}


def resolve(name: str) -> TrafficStats:
    """Resolve one symbolic scenario name to its TrafficStats.

    ``cnn/<workload>/<stage>@b<batch>`` routes through the shared memoized
    ``workload_engine.stats_for`` (the paper-CNN entry point);
    ``lm/<arch>/<shape>`` through :func:`lm_traffic`.  Both are memoized,
    so a resolved spec shares scenario objects — and therefore the
    ``sweep.run`` memo — with the equivalent Python-constructed spec.
    """
    kind, _, rest = name.partition("/")
    if kind == "cnn":
        workload_name, _, stage_spec = rest.partition("/")
        stage, sep, batch_s = stage_spec.partition("@b")
        if stage not in _STAGES or not sep or not batch_s.isdigit():
            raise ValueError(
                f"bad CNN scenario {name!r}: expected "
                "'cnn/<workload>/{train|infer}@b<batch>'")
        return workload_engine.stats_for(workloads.get(workload_name),
                                         int(batch_s), _STAGES[stage])
    if kind == "lm":
        arch, _, shape_spec = rest.partition("/")
        shape, sep, batch_s = shape_spec.partition("@b")
        if sep and (not batch_s.isdigit() or int(batch_s) < 1):
            raise ValueError(f"bad LM scenario {name!r}: expected "
                             "'lm/<arch>/<shape>[@b<batch>]' with a "
                             "positive batch")
        if shape not in SHAPES:
            raise ValueError(f"bad LM scenario {name!r}: unknown shape "
                             f"{shape!r}; available: {sorted(SHAPES)}")
        if arch not in configs.all_archs():
            raise ValueError(f"bad LM scenario {name!r}: unknown arch "
                             f"{arch!r}; available: {configs.all_archs()}")
        if not lm_supported(arch, shape):
            raise ValueError(f"unsupported LM scenario {name!r}: "
                             f"{shape} needs a sub-quadratic architecture")
        return lm_traffic(arch, shape, int(batch_s) if sep else None)
    raise ValueError(f"unknown scenario namespace in {name!r}: expected "
                     "'cnn/...' or 'lm/...'")


def name_of(stats: TrafficStats) -> str:
    """Inverse of :func:`resolve` — the symbolic name of a registry-built
    scenario (LM cells carry their 'arch/shape' key as the workload)."""
    if "/" in stats.workload:
        return f"lm/{stats.workload}"
    stage = "train" if stats.training else "infer"
    return f"cnn/{stats.workload}/{stage}@b{stats.batch}"


def names(cnn_stages: Sequence[tuple[bool, int]] = ((False, 4), (True, 64)),
          lm_batches: Sequence[int] = LM_BATCHES) -> tuple[str, ...]:
    """Every scenario name the registry resolves, CNNs at the given
    (training, batch) stages and LM cells at the default batch plus each
    registered ``@b<n>`` override (both namespaces are batch-parametric,
    so representative batches only are enumerated)."""
    cnn = tuple(f"cnn/{w}/{'train' if t else 'infer'}@b{b}"
                for w in workloads.registry() for t, b in cnn_stages)
    lm = tuple(f"lm/{a}/{s}{suffix}"
               for a in configs.all_archs() for s in LM_SHAPES
               if lm_supported(a, s)
               for suffix in ("",) + tuple(f"@b{b}" for b in lm_batches))
    return cnn + lm


# The mega-sweep's CNN batch axis: powers of two through the paper's
# largest studied batch regime.  15 values x 2 stages x 5 workloads = 150
# CNN scenarios; with the 32 LM cells and the 4-node x 24-capacity x 3-mem
# design grid x 2 platforms this crosses 1e5 cells.
MEGA_BATCHES = tuple(2 ** i for i in range(15))          # 1 .. 16384
MEGA_CAPACITIES_MB = (0.5, 1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10, 12, 16, 20,
                      24, 28, 32, 40, 48, 56, 64, 72, 80, 96)


def mega_spec(quick: bool = False) -> sweep.SweepSpec:
    """The full DTCO cross product as one spec: every CNN workload x stage
    x batch, every supported LM (arch x shape) cell, x every (node x
    capacity x memory) design point x both platforms — the 1e5-cell space
    the sharded lowering (``sweep.ShardPlan``) exists for.  ``quick``
    shrinks every axis to a CI-smoke size (a few hundred cells) with the
    same heterogeneous shape."""
    from repro_torch.core.tech import NODES, PLATFORMS
    batches = (4, 64) if quick else MEGA_BATCHES
    caps = (1.0, 3.0) if quick else MEGA_CAPACITIES_MB
    nodes = tuple(NODES.values())[:2 if quick else None]
    cnn = tuple(workload_engine.stats_for(w, b, t)
                for w in workloads.registry().values()
                for t in (False, True) for b in batches)
    lm = lm_scenarios(shapes=("train_4k", "decode_32k") if quick
                      else LM_SHAPES)
    return sweep.SweepSpec(
        name="mega-quick" if quick else "mega",
        scenarios=cnn + lm,
        designs=sweep.design_grid(sweep.MEMS, caps, nodes=nodes),
        platforms=tuple(PLATFORMS.values()))


def lm_sweep_spec(capacity_mb: float = LM_CAPACITY_MB,
                  mems: Sequence[str] = sweep.MEMS,
                  platforms: Sequence[Platform] = (TPU_V5E,),
                  archs: Sequence[str] | None = None,
                  shapes: Sequence[str] = LM_SHAPES,
                  nodes: TechNode | Sequence[TechNode] = (TECH_16NM,),
                  name: str = "lm-nvm") -> sweep.SweepSpec:
    """The LM study as one declarative sweep: every supported (arch x
    shape) cell x every (node x memory) design at the TPU-class buffer
    capacity x the requested platforms.  ``nodes`` is the cross-node DTCO
    entry point: several nodes batch through the same single circuit-call
    + single fold-call pipeline, each normalized to its own-node SRAM."""
    return sweep.SweepSpec(
        name=name,
        scenarios=lm_scenarios(archs, shapes),
        designs=sweep.design_grid(mems, (capacity_mb,), nodes=nodes),
        platforms=tuple(platforms))
