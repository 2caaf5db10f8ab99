"""Design-space exploration on the PyTorch port (the paper's framework
claim): sweep technology x capacity x workload x platform — and, for the
DTCO section, x technology node — and emit the EDP landscape.

The same study as ``examples/nvm_dse.py``, through ``repro_torch``: one
declarative SweepSpec lowers to a single circuit-engine evaluation of
every (node x tech x capacity x organization) design point plus a single
workload-engine fold, in float64 on ``--device`` (cuda unless ``cpu`` is
given; without CUDA it raises).

    PYTHONPATH=src python examples/torch_nvm_dse.py                   # cuda
    PYTHONPATH=src python examples/torch_nvm_dse.py --device cpu
"""
import argparse

from repro_torch.core import dtco, sweep
from repro_torch.core.report import markdown_table
from repro_torch.core.tech import GTX_1080TI, TPU_V5E
from repro_torch.core.workloads import paper_workloads

CAPS_MB = (2, 3, 6, 12, 24)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="device the engines run on (default cuda)")
device = ap.parse_args().device

spec = sweep.SweepSpec(
    name="nvm-dse",
    scenarios=sweep.workload_scenarios(paper_workloads(), ((False, 4),)),
    designs=sweep.design_grid(sweep.MEMS, CAPS_MB),
    platforms=(GTX_1080TI, TPU_V5E),
)
res = sweep.run(spec, device=device)

# normalized EDP per (platform, workload, design), baseline = SRAM of the
# same capacity group; the query layer slices the labeled axes directly
rows = [dict(platform=r["platform"], capacity_mb=r["capacity_mb"],
             workload=r["workload"], mem=r["mem"],
             edp_reduction=round(1.0 / r["edp_x"], 2))
        for r in res.filter(mem=("stt", "sot")).rows(include_dram=True)]
print(markdown_table(rows))
best = max(rows, key=lambda r: r["edp_reduction"])
print("\nbest design point:", best)

# -- DSE reductions: Pareto fronts + capacity plateaus -----------------------
# Non-dominated (energy, runtime, area) designs per scenario, and the
# capacity beyond which growing the cache buys < 5% EDP.
front = res.pareto_front()
print(f"\npareto front (energy/runtime/area): {len(front)} of "
      f"{len(res.rows())} rows survive; alexnet×gtx front:")
print(markdown_table(
    [{k: r[k] for k in ("mem", "capacity_mb", "energy", "runtime", "area")}
     for r in front
     if r["platform"] == "gtx-1080ti" and r["workload"] == "alexnet"]))
plateaus = [p for p in res.capacity_plateaus()
            if p["platform"] == "gtx-1080ti" and p["workload"] == "alexnet"]
print("\ncapacity plateaus (alexnet, EDP within 5% of best):")
print(markdown_table([{k: p[k] for k in ("mem", "plateau_capacity_mb",
                                         "best_capacity_mb")}
                      for p in plateaus]))

# -- cross-node DTCO: the node as one more batched axis ----------------------
# One design_table call covers 16/12/10/7 nm; every node is normalized to
# its own SRAM baseline (the per-node comparison DTCO studies make).
trend = dtco.analyze(capacity_mb=3, device=device)
print("\ncross-node iso-capacity trend (3 MB, GTX 1080 Ti workloads):")
print(markdown_table([dict(node=r.node, mem=r.mem,
                           leakage_w=round(r.leakage_w, 3),
                           leak_x=round(r.leak_x, 4),
                           edp_x=round(r.edp_x, 4))
                      for r in trend]))
head = dtco.headline(trend)
print(f"\nSRAM leakage {head['sram']['leak_w_first']:.2f} W @16nm -> "
      f"{head['sram']['leak_w_last']:.2f} W @7nm "
      f"(x{head['sram']['leak_growth']:.2f}); "
      f"SOT EDP reduction {head['sot']['edp_reduction_first']:.2f}x @16nm -> "
      f"{head['sot']['edp_reduction_last']:.2f}x @7nm")
