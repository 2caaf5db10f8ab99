"""One run of one cell: set-up, a measured window of `--seconds`, the check
against the reference, and the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic mix names its kind ("train" or "serve"), whose driver
lives in `kinds/<kind>.py`.  With `--trace 0` the line carries the cell's
end-to-end metrics; with `--trace 1` a stretch at the start of the window
is profiled, with spans around the program functions that the readers
name, and the line carries the per-layer metrics.  Without a CUDA device
for each chip that the cell asks for it exits 2 and prints no result;
where `jax`, `jaxlib`, `flax` or `repro` was loaded it exits 3."""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a kind's driver is given."""
    bench: dict
    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    per_layer: list
    end_to_end: list
    arch: object               # the configuration's module, `spec.arch`
    here: Path = spec.HERE     # the portbench directory the files came from


@dataclasses.dataclass
class Outcome:
    """What a kind's driver hands back."""
    attempted: int
    failed: int
    e2e: dict                  # name -> value
    memory_peak_bytes: int
    numbers: dict              # the numbers `correct` may compare
    where: dict                # where each was read (leaf, counts, phases)
    profile: object = None     # (trace.Reduced, readers, ctx) if traced


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def free(device) -> None:
    import torch
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def readers(run: Run) -> dict:
    return {m["name"]: spec.reader(m["name"], run.here)
            for m in run.per_layer}


def span_targets(mods: dict) -> dict:
    targets = {}
    for mod in mods.values():
        targets.update(getattr(mod, "SPANS", {}))
    return targets


class Profiler:
    """The traced stretch: spans installed and torch.profiler on between
    `start` and `stop`, both after a device sync."""

    def __init__(self, run: Run, mods: dict):
        from portbench.spans import Spans
        self.run, self.spans = run, Spans(span_targets(mods))
        self.prof = None
        self.on = False

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.run.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.spans.install()
        self.prof = profile(activities=acts)
        self.prof.start()
        # a first op, so that the tracer is running before the stretch
        torch.ones(1, device=self.run.device).add_(1)
        sync(self.run.device)
        self.span = torch.profiler.record_function("pb:stretch")
        self.span.__enter__()
        self.on = True

    def stop(self):
        sync(self.run.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.spans.remove()
        self.on = False

    def reduce(self):
        from portbench import trace
        roots, dev = trace.from_profiler(self.prof.events())
        stretch = next(e for e in roots if e.name == "pb:stretch")
        return trace.reduce(roots, dev, (stretch.t0, stretch.t1),
                            host_thread=stretch.thread)


def run_cell(run: Run) -> tuple[dict, dict]:
    """(result line, checks) of one run."""
    import torch
    from portbench import correct
    kind = importlib.import_module(f"portbench.kinds.{run.mix['kind']}")
    out: Outcome = kind.run(run)
    ok, check = correct.judge(out.numbers, run.limits, out.failed)
    result = {"correct": ok, "attempted": out.attempted, "failed": out.failed}
    if run.trace:
        red, mods, ctx = out.profile
        metrics = {}
        for m in run.per_layer:
            value = mods[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": out.e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in run.end_to_end}
    on_cuda = run.device.startswith("cuda")
    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
              "count": run.cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace:
        red = out.profile[0]
        device["busy_s"] = red.busy_us / 1e6
        device["window_s"] = red.window_us / 1e6
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in red.device_ops[:10]],
            "idle_gaps": [[n, us / 1e6] for n, us in red.idle_gaps[:10]]}
    result["device"] = device
    result["check"] = check
    where = dict(out.where, **{f"{k} (not compared)": v for k, v in
                               out.numbers.items() if k not in run.limits})
    return result, {"check": check, "where": where}


def make_run(workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, here: Path = spec.HERE,
             root: Path = spec.REPO) -> Run:
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    e2e, per_layer = spec.metrics_of(bench, workload)
    cfg = spec.config(cell["config"], here)
    return Run(bench=bench, cell=cell, cfg=cfg,
               mix=spec.traffic(cell["traffic"], here),
               limits=spec.limits(workload, here), seed=seed,
               seconds=seconds, trace=trace, device=device, t_start=t_start,
               per_layer=per_layer, end_to_end=e2e,
               arch=spec.arch(cfg, here), here=here)


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"this machine has {have}: no result", file=sys.stderr)
        return 2
    run = make_run(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    result, info = run_cell(run)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}; no result",
              file=sys.stderr)
        return 3
    where = ", ".join(f"{k} {v}" for k, v in info["where"].items())
    print(f"where: {where}", file=sys.stderr)
    for name, c in info["check"].items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
