"""DeepNVM++ — cross-layer NVM cache modeling framework (the paper's core),
ported to PyTorch: the float64 engines run on ``cuda`` unless the caller
passes ``device="cpu"``.

Layers (paper Fig. 2):
    mtj / bitcell      circuit-level device characterization   (Table I)
    cachemodel / tuner NVSim-style cache design + Alg. 1       (Table II)
    engine             ... the circuit sweep as one batched computation
    workloads / traffic DL workload memory statistics          (SIII-C)
    workload_engine    ... the workload fold as one batched computation
    sweep              one declarative SweepSpec driving both engines
                       (+ the symbolic, JSON-round-trippable v2 form)
    dse                Pareto fronts / capacity plateaus on SweepResults
    isocap / isoarea / scaling   architecture-level analyses   (Figs 3-10)
    device             the pipeline's device argument and its memo key
"""

from repro_torch.core import (  # noqa: F401
    bitcell,
    cachemodel,
    calibration,
    device,
    dse,
    engine,
    isoarea,
    isocap,
    mtj,
    report,
    scaling,
    sweep,
    tech,
    traffic,
    tuner,
    workload_engine,
    workloads,
)
