"""Training: the step that `make_train_step(LM.loss, ...)` returns, wired
as the port's `launch.train.build_trainer` wires it (fp32 masters, AdamW
with the configuration's schedule, remat), over the benchmark's seeded
weights, driven back to back on Markov batches with no host sync inside
the window.

Set-up drives the first `checked_steps` steps through the same step call
and feed; they are the warm-up, and the comparison reads them: each step's
loss, the first gradient's norm a leaf (from AdamW's m after step 1), and
each leaf's change over the checked steps (against the weights drawn again
from the seed)."""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench import correct, gen, weights
from portbench.harness import Outcome, Profiler, Run, free, readers, sync


def _feed(run: Run):
    mix, dev = run.mix, run.device
    markov = gen.Markov(run.cfg["vocab"], run.seed, mix["branching"])

    def batch(step: int) -> dict:
        b = markov.batch(step, mix["batch"], mix["seq_len"])
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
            if dev.startswith("cuda"):
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        return out
    return batch


def _norms(tensors) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


def program_steps(run: Run, params: dict, batch, n_check: int):
    """Builds the port's trainer over `params` and drives the checked
    steps.  Returns (state, step, readings of the program)."""
    from repro_torch.launch.specs import schedule_for
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim import AdamWConfig, adamw_init, make_train_step
    cfg = run.cfg
    arch = run.arch.port_config(cfg)
    o = cfg["optimizer"]
    model = lm_mod.build(arch, remat=cfg["remat"])
    step = make_train_step(model.loss, AdamWConfig(
        b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
        clip_norm=o["clip_norm"], schedule=schedule_for(arch)))
    state = adamw_init(params)
    losses = []
    grad_norms = None
    for k in range(n_check):
        b = batch(k)
        if k == n_check - 1:
            sync(run.device)
            t = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"])
        if k == 0:
            grad_norms = _norms(t for _, t in weights.leaves(state.mu)) / (
                1 - o["b1"])
    sync(run.device)
    step_s = time.perf_counter() - t
    p0 = weights.make(cfg, run.seed, run.device, torch.float32, run.arch)
    delta = _norms(p.detach() - q for (_, p), (_, q) in zip(
        weights.leaves(state.params), weights.leaves(p0)))
    del p0
    readings = {"losses": losses, "grad_norms": grad_norms,
                "delta_norms": delta, "step_s": step_s}
    return state, step, readings


def reference_steps(run: Run, batch, n_check: int, prec: str = "fp32"):
    """The reference's readings over the same weights and batches."""
    from portbench.reference.model import strict_fp32
    from portbench.reference.train import Trainer
    strict_fp32()
    params = weights.make(run.cfg, run.seed, run.device, torch.float32,
                          run.arch)
    tr = Trainer(run.arch.Reference(run.cfg, prec), params)
    losses, grad_norms = [], None
    for k in range(n_check):
        b = batch(k)
        loss, norms = tr.step(b["tokens"], b["labels"])
        losses.append(loss)
        if k == 0:
            grad_norms = norms
    tr.free_state()
    free(run.device)
    p0 = weights.make(run.cfg, run.seed, run.device, torch.float32,
                      run.arch)
    delta = [(p - q).norm().item() for (_, p), (_, q) in zip(
        weights.leaves(params), weights.leaves(p0))]
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}


def run(run: Run) -> Outcome:
    mix, dev = run.mix, run.device
    n_check = mix["checked_steps"]
    tokens_per_step = mix["batch"] * mix["seq_len"]
    batch = _feed(run)
    phases, t = {}, time.perf_counter()
    params = weights.make(run.cfg, run.seed, dev, torch.float32, run.arch)
    names = weights.names(run.cfg, run.arch)
    sync(dev)
    phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
    state, step, prog = program_steps(run, params, batch, n_check)
    del params
    phases["checked_steps_s"], t = time.perf_counter() - t, time.perf_counter()
    # the window's batches, made and moved to the device beforehand: half
    # as many again as the checked step's time says the window holds
    pool = [batch(n_check + i) for i in range(
        math.ceil(1.5 * run.seconds / max(prog["step_s"], 1e-3)) + 2)]
    phases["batches_s"] = time.perf_counter() - t
    mods = readers(run) if run.trace else {}
    prof = Profiler(run, mods) if run.trace else None

    if prof:
        prof.start()
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    n, enqueue = n_check, []
    traced = 0
    while time.perf_counter() - t0 < run.seconds:
        i = n - n_check
        b = pool[i] if i < len(pool) else batch(n)
        tc = time.perf_counter()
        state, _ = step(state, b)
        enqueue.append(time.perf_counter() - tc)
        n += 1
        if prof and n - n_check == mix["trace_steps"]:
            prof.stop()
            traced = n - n_check
    sync(dev)
    t1 = time.perf_counter()
    if prof and prof.on:
        prof.stop()
        traced = n - n_check
    steps = n - n_check
    peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
    prog = {"losses": [float(x) for x in prog["losses"]],
            "grad_norms": prog["grad_norms"].tolist(),
            "delta_norms": prog["delta_norms"].tolist()}
    del state, step, pool
    free(dev)

    t_ref = time.perf_counter()
    ref = reference_steps(run, batch, n_check)
    t_ref = time.perf_counter() - t_ref
    cmp = correct.train_numbers(prog, ref, names)
    profile = None
    if prof:
        red = prof.reduce()
        ctx = {"run": run, "reduced": red, "calls": prof.spans.calls,
               "host_enqueue_s": enqueue[traced:] or enqueue,
               "stretch_flops": traced * run.arch.train_step_flops(
                   run.cfg, mix["batch"], mix["seq_len"]),
               "stretch_steps": traced}
        profile = (red, mods, ctx)
    e2e = {"train_tokens_per_s": steps * tokens_per_step / (t1 - t0),
           "setup_s": setup_s, "peak_mem_gib": peak / 2**30}
    where = dict(cmp["where"], steps=steps, window_s=t1 - t0, **phases,
                 enqueue_ms_median=1e3 * statistics.median(enqueue),
                 reference_s=t_ref)
    return Outcome(attempted=steps, failed=0, e2e=e2e,
                   memory_peak_bytes=peak, numbers=cmp["numbers"],
                   where=where, profile=profile)
