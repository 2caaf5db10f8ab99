"""Public sweep API + the ``python -m repro_torch.sweep`` service entry
point.

Re-exports the declarative pipeline (repro_torch.core.sweep) and the
symbolic SweepSpec v2 document layer so consumers address one namespace:

    from repro_torch import sweep
    result = sweep.load_spec("spec.json").run()               # on cuda
    result = sweep.load_spec("spec.json").run(device="cpu")

``python -m repro_torch.sweep run|show|mega|serve`` dispatches to
repro_torch.sweep_cli; the concurrent service layer (transports,
coalescing, cache, warmup) lives in ``repro_torch.sweep.service`` with a
stdlib client in ``repro_torch.sweep.client``.
"""

from repro_torch.core.sweep import (  # noqa: F401
    SCHEMA,
    DesignCorners,
    DesignGrid,
    DesignPoint,
    ShardPlan,
    SweepResult,
    SweepSpec,
    SweepView,
    SymbolicSweepSpec,
    design_corners,
    design_grid,
    design_name,
    group_label,
    iter_shards,
    load_spec,
    lower_designs,
    merge_results,
    n_cells,
    parse_design,
    run,
    run_sharded,
    spec_union,
    split,
    workload_scenarios,
)
from repro_torch.sweep.service import (  # noqa: F401
    Coalescer,
    ResultCache,
    SweepHTTPServer,
    SweepService,
    SweepUnixServer,
    enable_compilation_cache,
    evaluate_spec,
    serve_stdio,
    spec_key,
)

__all__ = [
    "SCHEMA", "Coalescer", "DesignCorners", "DesignGrid", "DesignPoint",
    "ResultCache", "ShardPlan", "SweepHTTPServer", "SweepResult",
    "SweepService", "SweepSpec", "SweepUnixServer", "SweepView",
    "SymbolicSweepSpec", "design_corners", "design_grid", "design_name",
    "enable_compilation_cache", "evaluate_spec", "group_label",
    "iter_shards", "load_spec", "lower_designs", "merge_results",
    "n_cells", "parse_design", "run", "run_sharded", "serve_stdio",
    "spec_key", "spec_union", "split", "workload_scenarios",
]
