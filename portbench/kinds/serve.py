"""Serving: an open loop of prompt batches through the port's
`launch.serve.generate`, over the benchmark's seeded bf16 weights.

A batch of `batch` prompts of one length is due at the times of the mix's
schedule (`gen.serve_schedule`), whether or not the previous one is done;
the loop waits for a batch's due time, calls `generate`, and reads its
tokens on the host.  A request's time to first token runs from its batch's
due time to then, queueing included.  Set-up draws the weights and every
prompt and warms each length once.

In the window a tap on the port's `layers.unembed` keeps the prefill's
last-position logits of the `check_batches` batches drawn from the seed
(one of each length, the longest among them).  After the window the
reference runs over those batches' prompts: the comparison holds the
program's logits against the reference's, and reads how far each served
token's logit lies below the reference's best."""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch

from portbench import correct, gen, weights
from portbench.harness import Outcome, Profiler, Run, free, readers, sync
from portbench.spans import Tap, span

UNEMBED = "repro_torch.models.layers:unembed"


def percentile(values: list[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of all at or
    below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.0005) if left < 0.002 else left - 0.001)


def prompts_of(run: Run, schedule) -> dict:
    markov = gen.Markov(run.cfg["vocab"], run.seed, run.mix["branching"])
    out = {}
    for b in schedule:
        p = markov.prompts(b["index"], run.mix["batch"], b["length"])
        out[b["index"]] = torch.from_numpy(p.astype(np.int64)).to(run.device)
    return out


def reference_gaps(run: Run, prompts: dict, served: dict, logits: dict,
                   check: list[int], prec: str = "fp32"):
    """(token gaps, logit gaps), one a request of the `check` batches: the
    served tokens and the program's last-position logits against the
    reference's over the same prompts.  A batch whose logits the program
    never produced reads an infinite logit gap."""
    from portbench.reference.model import strict_fp32
    strict_fp32()
    params = weights.make(run.cfg, run.seed, run.device, torch.bfloat16,
                          run.arch)
    ref = run.arch.Reference(run.cfg, prec)
    gaps, rel = [], []
    for i in check:
        want = ref.last_logits(params, prompts[i])
        gaps += correct.token_gaps(want, served[i][:, 0].to(want.device))
        got = logits.get(i)
        rel += (correct.logit_gaps(want, got) if got is not None
                and got.shape == want.shape else [math.inf] * len(want))
    return gaps, rel


def run(run: Run) -> Outcome:
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm as lm_mod
    mix, dev = run.mix, run.device
    bsz, new = mix["batch"], mix["new_tokens"]
    phases, t = {}, time.perf_counter()
    model = lm_mod.build(run.arch.port_config(run.cfg))
    params = weights.make(run.cfg, run.seed, dev, torch.bfloat16, run.arch)
    sync(dev)
    phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
    schedule = gen.serve_schedule(mix, run.seconds)
    check = gen.check_sample(schedule, mix["check_batches"], run.seed)
    prompts = prompts_of(run, schedule)
    phases["prompts_s"], t = time.perf_counter() - t, time.perf_counter()
    warmed = set()
    for b in schedule:   # every length the window will see, once
        if b["length"] not in warmed:
            warmed.add(b["length"])
            generate(model, params, prompts[b["index"]], b["length"] + new,
                     new).cpu()
    phases["warm_s"] = time.perf_counter() - t
    mods = readers(run) if run.trace else {}
    prof = Profiler(run, mods) if run.trace else None

    tap, checked = Tap(UNEMBED), set(check)
    try:
        if prof:
            prof.start()
        sync(dev)
        t0 = time.perf_counter()
        setup_s = t0 - run.t_start
        ttft, served, enqueue, late, logits = [], {}, [], [], {}
        for b in schedule:
            due = t0 + b["due"]
            with (span("wait") if prof and prof.on
                  else contextlib.nullcontext()):
                _wait_until(due)
            tc = time.perf_counter()
            late.append(tc - due)
            tap.armed = b["index"] in checked
            with (span(f"serve.batch#{b['index']}") if prof and prof.on
                  else contextlib.nullcontext()):
                toks = generate(model, params, prompts[b["index"]],
                                b["length"] + new, new)
                enqueue.append(time.perf_counter() - tc)
                served[b["index"]] = toks.cpu()
            t_done = time.perf_counter()
            ttft += [t_done - due] * served[b["index"]].shape[0]
            kept = tap.take()
            if kept:   # the prefill's, the first unembedding of the call
                logits[b["index"]] = kept[0][:, -1] if kept[0].dim() == 3 \
                    else kept[0]
            if prof and b["index"] + 1 == mix["trace_batches"]:
                prof.stop()
        if prof and prof.on:
            prof.stop()
        t1 = time.perf_counter()
    finally:
        tap.remove()
    peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
    attempted = bsz * len(schedule)
    failed = sum(bsz - min(bsz, s.shape[0]) for s in served.values())
    del params, model
    free(dev)

    short = [i for i in check if served[i].shape != (bsz, new)]
    t_ref = time.perf_counter()
    gaps, rel = reference_gaps(run, prompts, served, logits,
                               [i for i in check if i not in short])
    t_ref = time.perf_counter() - t_ref
    cmp = correct.serve_numbers(gaps or [math.inf], rel or [math.inf])
    profile = None
    if prof:
        red = prof.reduce()
        n_tr = min(len(schedule), mix["trace_batches"])
        ctx = {"run": run, "reduced": red, "calls": prof.spans.calls,
               "host_enqueue_s": enqueue[n_tr:] or enqueue,
               "stretch_flops": sum(run.arch.prefill_flops(
                   run.cfg, bsz, b["length"]) for b in schedule[:n_tr]),
               "stretch_batches": n_tr}
        profile = (red, mods, ctx)
    e2e = {"ttft_ms_p95": 1e3 * percentile(ttft, 0.95), "setup_s": setup_s,
           "peak_mem_gib": peak / 2**30}
    where = dict(cmp["where"], **phases, batches=len(schedule),
                 ttft_ms_p50=1e3 * statistics.median(ttft),
                 window_s=t1 - t0, start_late_ms_max=1e3 * max(late),
                 reference_s=t_ref)
    return Outcome(attempted=attempted, failed=failed, e2e=e2e,
                   memory_peak_bytes=peak, numbers=cmp["numbers"],
                   where=where, profile=profile)
