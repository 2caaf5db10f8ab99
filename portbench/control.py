"""The control and the planted faults of a cell, read on the chip at the
cell's own size (`correct`'s upper readings):

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--seconds <run_seconds>]

One JSON line a seed, with the numbers that `correct` compares as read by
- "control": the reference put in the program's place with its linear
  layers in float8 e4m3 (one scale a tensor), the precision below the
  configuration's bfloat16;
- training, "half_batch": the reference stepping on the first half of each
  batch's rows, the mean taken over them ("unchanged", a step that leaves
  its state as it was, reads update_gap 1 by definition and needs no run);
- serving, "token_altered": the served token replaced by the next id.
Each against the float32 reference over the same weights and inputs.  The
harness's own runs never run this; the program's own readings come from
those runs (`run.py`), the timed path's."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":   # run as a script: import from the checkout
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _here]
    sys.path[:0] = [str(_here.parent), str(_here.parent / "src")]

from portbench import correct, gen, harness  # noqa: E402


def train_readings(run) -> dict:
    from portbench.kinds import train
    n = run.mix["checked_steps"]
    batch = train._feed(run)

    def half(step):
        b = batch(step)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}

    from portbench import weights
    names = weights.names(run.cfg, run.arch)
    t = time.perf_counter()
    ref = train.reference_steps(run, batch, n)
    secs = {"reference_s": time.perf_counter() - t}
    out = {}
    for label, feed, prec in (("control", batch, "fp8"),
                              ("half_batch", half, "fp32")):
        harness.free(run.device)
        t = time.perf_counter()
        got = train.reference_steps(run, feed, n, prec)
        secs[f"{label}_s"] = time.perf_counter() - t
        out[label] = correct.train_numbers(got, ref, names)
    return dict(out, seconds=secs)


def serve_readings(run) -> dict:
    import torch
    from portbench import weights
    from portbench.kinds.serve import prompts_of
    from portbench.reference.model import strict_fp32
    schedule = gen.serve_schedule(run.mix, run.seconds)
    check = gen.check_sample(schedule, run.mix["check_batches"], run.seed)
    prompts = prompts_of(run, [schedule[i] for i in check])
    strict_fp32()
    params = weights.make(run.cfg, run.seed, run.device, torch.bfloat16,
                          run.arch)
    gaps = {"control": [], "token_altered": []}
    rel = {"control": [], "token_altered": []}
    secs = {}
    for prec in ("fp32", "fp8"):
        t = time.perf_counter()
        ref = run.arch.Reference(run.cfg, prec)
        logits = {i: ref.last_logits(params, prompts[i]) for i in check}
        secs[f"{prec}_s"] = time.perf_counter() - t
        if prec == "fp32":
            base = logits
    for i in check:
        gaps["control"] += correct.token_gaps(base[i], logits[i].argmax(-1))
        rel["control"] += correct.logit_gaps(base[i], logits[i])
        best = base[i].argmax(-1)
        gaps["token_altered"] += correct.token_gaps(
            base[i], (best + 1) % run.cfg["vocab"])
        rel["token_altered"] += correct.logit_gaps(base[i], base[i])
    return dict({k: dict(correct.serve_numbers(gaps[k], rel[k]),
                         gaps=gaps[k], logit_gaps=rel[k]) for k in gaps},
                seconds=secs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True,
                    help="seeds of the control's and the faults' readings")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = harness.make_run(args.workload, seed, 0.0, False, "cuda",
                               time.perf_counter())
        run.seconds = args.seconds or run.bench["run_seconds"]
        out = (train_readings(run) if run.mix["kind"] == "train"
               else serve_readings(run))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        harness.free(run.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
