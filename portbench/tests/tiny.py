"""Tiny configurations and mixes for the CPU tests, and a copy of the
benchmark in a temporary directory whose cells run them under the real
cells' names.  Nothing here runs on the chip."""

from __future__ import annotations

import json
import math
import shutil
import time
from pathlib import Path

from portbench import harness, spec

DENSE = {"name": "minicpm-tiny", "family": "dense", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab": 256, "tied_embeddings": True,
         "qk_norm": False, "activation": "silu", "rope_theta": 10000.0,
         "rms_eps": 1e-6, "residual_scale": 1.4 / math.sqrt(2),
         "schedule": {"kind": "wsd", "peak": 0.01, "warmup": 2000,
                      "total": 100000, "decay_frac": 0.1, "final_frac": 0.01},
         "optimizer": {"kind": "adamw", "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "weight_decay": 0.1, "clip_norm": 1.0,
                       "no_decay": ["ln_f.scale"]},
         "loss": {"z_loss": 1e-4}, "remat": "full"}
MOE = {"name": "moe-tiny", "family": "moe", "n_layers": 2, "d_model": 64,
       "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "d_ff": 32,
       "vocab": 256, "tied_embeddings": False, "qk_norm": False,
       "activation": "silu", "rope_theta": 10000.0, "rms_eps": 1e-6,
       "residual_scale": 1.0,
       "moe": {"n_experts": 8, "top_k": 2, "d_expert": 32, "n_shared": 1,
               "first_dense_layers": 1, "dense_d_ff": 96, "group_size": 32,
               "capacity_factor": 1.25, "router_bias": True}}
TRAIN = {"kind": "train", "batch": 2, "seq_len": 32, "branching": 32,
         "checked_steps": 3, "trace_steps": 2}
SERVE = {"kind": "serve", "batch": 2, "lengths": [16, 24, 32],
         "new_tokens": 1, "arrivals": "poisson", "mean_interval_s": 0.05,
         "schedule_seed": 1, "branching": 32,
         "check_batches": 2, "trace_batches": 3}
# a size at which the models amplify rounding as the real ones do (10
# layers, d 256, hd 64, 4096 tokens, 32 requests checked): the control's
MID = {"dense": dict(DENSE, n_layers=10, d_model=256, n_heads=4, n_kv_heads=4,
                     head_dim=64, d_ff=1024, vocab=4096),
       "moe": dict(MOE, n_layers=10, d_model=256, n_heads=4, n_kv_heads=4,
                   head_dim=64, vocab=4096,
                   moe=dict(MOE["moe"], n_experts=16, top_k=4, d_expert=128,
                            dense_d_ff=512, group_size=64)),
       "serve": dict(SERVE, batch=4, lengths=[96, 128], check_batches=8)}
# the real cells' names, run here on the tiny configurations
CELLS = {"minicpm-2b.train.4x2048": ("minicpm-tiny", "tiny.train"),
         "deepseek-moe-16b.serve.longprompt": ("moe-tiny", "tiny.serve")}


def copy(tmp: Path, mid: bool = False) -> tuple[Path, Path]:
    """(root, portbench) of a copy of the benchmark in `tmp` whose cells
    run the tiny configurations (`mid`: the MID ones)."""
    dense, moe, serve = ((MID["dense"], MID["moe"], MID["serve"]) if mid
                         else (DENSE, MOE, SERVE))
    tmp = Path(tmp)
    here = tmp / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    bench["configs"] = [
        {"name": c["name"], "source": "tiny", "reduced": [], "why": "test",
         "file": f"portbench/configs/{c['name']}.json"} for c in (dense, moe)]
    for w in bench["workloads"]:
        w["config"], w["traffic"] = CELLS[w["name"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in (dense, moe):
        (here / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    (here / "traffic" / "tiny.train.json").write_text(json.dumps(TRAIN))
    (here / "traffic" / "tiny.serve.json").write_text(json.dumps(serve))
    return tmp, here


def run(root: Path, here: Path, workload: str, seed: int = 2**31 + 77,
        seconds: float = 0.5, trace: bool = False) -> tuple[dict, dict]:
    """(result line, checks) of a run on the CPU, the look for a chip
    skipped."""
    r = harness.make_run(workload, seed, seconds, trace, "cpu",
                         time.perf_counter(), here=here, root=root)
    return harness.run_cell(r)


def make(root: Path, here: Path, workload: str, seed: int = 2**31 + 77,
         seconds: float = 0.5):
    return harness.make_run(workload, seed, seconds, False, "cpu",
                            time.perf_counter(), here=here, root=root)
