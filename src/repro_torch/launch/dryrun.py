"""The dry run, ported from `repro.launch.dryrun`: trace every (arch x
shape) cell without allocating, and record what the roofline
(`launch.roofline`) reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape train_4k --out runs/dryrun [--device cpu]

The port runs on one device (`launch.mesh`), so a cell is traced for one
H100, not lowered for a TPU mesh.  The cell is built and stepped once
under `FakeTensorMode` (torch's `jax.eval_shape`: every tensor has a
shape, a dtype and a device, and no data), on fake tensors of `--device`
(`cuda` by default; without CUDA it raises unless `--device cpu` is
given).  On fake CUDA tensors the hand-written kernels' wrappers are their
shape functions (`kernels/flash_attention.py`, `wkv6.py`,
`selective_scan.py`): they allocate what the kernels would and launch
nothing.  On fake CPU tensors the plain twins run, token by token for
wkv6 and the scan, so keep CPU cells short.

One record per cell, with the JAX record's keys:

* `memory`: `argument_bytes` (the cell's arguments), `output_bytes`
  (what the step returns), `peak_bytes` (the most live tensor bytes while
  it runs, by `torch.distributed._tools.mem_tracker.MemTracker`, which
  rounds each allocation as the CUDA caching allocator does) and
  `temp_bytes` (peak less arguments);
* `cost.flops`: `torch.utils.flop_counter.FlopCounterMode`'s total, the
  matrix products and SDPA calls.  Like XLA's count of a Pallas call, it
  leaves the hand-written kernels out (flash attention, wkv6, the scan);
* `collectives`: the five kinds, all zero: one device moves nothing over
  a link;
* `device` and `device_memory_bytes` (`torch.cuda.get_device_properties`;
  None on the CPU).

The JAX CLI's `--mesh multi`, `--fsdp`, `--act-shard` and
`--seq-parallel` name multi-chip layouts and are not taken; neither is
its HLO parse of collective bytes (there is no HLO).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.utils._pytree as pytree
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.specs import Cell, build_cell

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
MESH = "host"
KV_FP8 = torch.float8_e4m3fn


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensors among `tree`'s leaves."""
    seen = {id(t): t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}
    return sum(t.nbytes for t in seen.values())


def dry_run(cell: Cell) -> dict:
    """Step `cell` once, under its fake mode (the active one, or the one
    its arguments were made in): {"status", "compile_s", "memory",
    "cost"}.  Its arguments are updated in place as a real step
    updates them, so step a cell once."""
    args = [t for t in pytree.tree_leaves(cell.args)
            if isinstance(t, torch.Tensor)]
    mode = detect_fake_mode(args)
    if mode is None:
        raise ValueError(f"{cell.name}: no fake tensors among the cell's "
                         "arguments: build it under FakeTensorMode")
    arg_bytes = tensor_bytes(cell.args)
    tracker = MemTracker()
    tracker.track_external(*args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with (mode if detect_fake_mode() is None else contextlib.nullcontext()), \
            flops, tracker:
        out = cell.step_fn(*cell.args)
    compile_s = time.perf_counter() - t0
    peak = sum(stats["Total"] for stats in
               tracker.get_tracker_snapshot("peak").values())
    return {"status": "ok", "compile_s": round(compile_s, 2),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": tensor_bytes(out),
                       "temp_bytes": peak - arg_bytes,
                       "peak_bytes": peak},
            "cost": {"flops": int(flops.get_total_flops())}}


def _device_record(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"device": None, "device_memory_bytes": None}
    props = torch.cuda.get_device_properties(dev)
    return {"device": props.name, "device_memory_bytes": props.total_memory}


def run_cell(arch: str, shape_name: str, out_dir: str | None, *,
             reduced: bool = False, remat: str = "full", kv_fp8: bool = False,
             tag: str = "", device="cuda") -> dict:
    """Build the cell under a new FakeTensorMode on fake tensors of
    `device` and dry-run it; write `<arch>__<shape>__host<tag>.json` to
    `out_dir` (None: nowhere) and return the record.  `long_500k` is
    skipped for a model that is not sub-quadratic."""
    cfg = configs.get(arch, reduced=reduced)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
               "status": "skipped(full-attention)"}
        _emit(rec, out_dir, tag)
        return rec
    dev = resolve_device(device)
    kv_dtype = KV_FP8 if kv_fp8 else torch.bfloat16
    with FakeTensorMode():
        t0 = time.perf_counter()
        cell = build_cell(cfg, shape, device=dev, remat=remat,
                          kv_cache_dtype=kv_dtype)
        lower_s = time.perf_counter() - t0
        got = dry_run(cell)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "n_devices": 1, "fsdp": False, "act_shard": False,
           "seq_parallel": False, "remat": remat, "kv_fp8": kv_fp8,
           "status": got["status"], "lower_s": round(lower_s, 2),
           "compile_s": got["compile_s"], "memory": got["memory"],
           "cost": got["cost"],
           "collectives": {"bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
                           "counts": dict.fromkeys(COLLECTIVE_KINDS, 0)},
           **_device_record(dev)}
    _emit(rec, out_dir, tag)
    return rec


def _emit(rec: dict, out_dir: str | None, tag: str = ""):
    line = (f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}{tag}] "
            f"{rec['status']}"
            + (f" trace={rec.get('compile_s')}s "
               f"flops={rec.get('cost', {}).get('flops')} "
               f"peak={rec['memory']['peak_bytes']}"
               if rec["status"] == "ok" else ""))
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--kv-fp8", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run_cell(args.arch, args.shape, args.out, reduced=args.reduced,
                    remat=args.remat, kv_fp8=args.kv_fp8, tag=args.tag,
                    device=args.device)


if __name__ == "__main__":
    main()
