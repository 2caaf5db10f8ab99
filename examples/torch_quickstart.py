"""Quickstart on the PyTorch port: the DeepNVM++ pipeline end to end.

    PYTHONPATH=src python examples/torch_quickstart.py                # cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The same steps as ``examples/quickstart.py``, through ``repro_torch``:
the engines run in float64 on ``--device`` (cuda unless ``cpu`` is given;
without CUDA it raises).

1. characterize bitcells (paper Table I),
2. EDAP-tune caches at 3 MB (paper Table II / Algorithm 1),
3. fold a DL workload's memory behavior through the models (paper Fig. 4),
4. ask the paper's question for one assigned LM arch on the TPU target.
"""
import argparse

from repro_torch import scenarios
from repro_torch.core import bitcell, sweep, traffic, tuner
from repro_torch.core.tech import TPU_V5E
from repro_torch.core.workloads import alexnet

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="device the engines run on (default cuda)")
device = ap.parse_args().device

# 1. circuit layer
for name, cell in bitcell.table1().items():
    print(f"{name}: write {cell.write_latency_avg_s*1e9:.2f} ns "
          f"{cell.write_energy_avg_j*1e12:.2f} pJ area {cell.area_norm}x")

# 2. microarchitecture layer (Algorithm 1)
designs = {m: tuner.tuned_design(m, 3, device=device)
           for m in ("sram", "stt", "sot")}
for m, d in designs.items():
    print(f"{m}: rd {d.read_latency_s*1e9:.2f} ns, leak {d.leakage_w:.2f} W, "
          f"area {d.area_mm2:.2f} mm2 [{d.org}]")

# 3. architecture layer: AlexNet inference on the 1080 Ti calibration target
stats = traffic.build(alexnet(), batch=4, training=False)
for m, d in designs.items():
    rep = traffic.energy(stats, d)
    print(f"{m}: E {rep.total_j(False)*1e3:.1f} mJ, EDP "
          f"{rep.edp(True)*1e6:.2f} mJ*ms")

# 4. the same question for an assigned LM architecture on TPU-class HW,
#    as one declarative sweep (scenario registry + unified pipeline)
res = sweep.run(scenarios.lm_sweep_spec(
    archs=("tinyllama-1.1b",), shapes=("decode_32k",),
    platforms=(TPU_V5E,)), device=device)
edp_x = res.norm_to().metric("edp", include_dram=True)
for m in ("stt", "sot"):
    print(f"tinyllama decode_32k, {m} 48MB buffer: "
          f"EDP reduction {1 / edp_x[0, 0, res.design_index(m)]:.1f}x")

# 5. the same sweep as a serializable document (SweepSpec v2): names
#    resolved through the registries, sharing the memoized result above —
#    this JSON is exactly what `python -m repro_torch.sweep run spec.json`
#    takes
sym = sweep.SymbolicSweepSpec(
    scenarios=("lm/tinyllama-1.1b/decode_32k",),
    designs=("sram@48MB", "stt@48MB", "sot@48MB"),
    platforms=("tpu-v5e",), name="lm-nvm")
# same registries, same memo (keyed on the device too), zero re-evaluation
assert sym.run(device=device) is res
print("\nsymbolic form:\n" + sym.to_json())
