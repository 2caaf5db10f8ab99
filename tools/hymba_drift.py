#!/usr/bin/env python3
"""Where Hymba-1.5B's prefill logits drift apart between two bf16 paths,
on the GPU machine:

    python3 tools/hymba_drift.py

Builds the kernels, initialises Hymba-1.5B at full width and depth (seed
0), and runs one 4 x 2048 prompt through four residual streams: the
kernels (flash attention, the selective scan), their plain twins, the
naive oracle and fp32 activations through the plain twins, printing
after every layer each stream's relative max
distance from the plain twin's (and the kernel's from fp32), and the
block's own kernel-vs-plain distance on the plain twin's input; then the
last position's logits of each, the prefills' logits, and one full-depth
prefill under torch.profiler with the time it took to aggregate.  Imports
no JAX."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch

import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
import repro_torch.configs as configs
from repro_torch.kernels import build
from repro_torch.models import layers, lm

card = cs.card_line()
print(f"card: {card}", flush=True)
build.build()
cfg = configs.get(cs.HYMBA_ARCH)
model = lm.build(cfg)
dev = torch.device("cuda")
params = model.init(torch.Generator(dev).manual_seed(0))
prompts = torch.randint(0, cfg.vocab, (cs.BATCH, cs.PROMPT), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
pos = torch.arange(cs.PROMPT, device=dev)[None]
rel = cs.rel_err
with torch.inference_mode():
    x0 = layers.embed(params["embed"], prompts)
    xs = {"kernel": x0, "plain": x0, "naive": x0, "fp32": x0.float()}
    force = {"kernel": None, "plain": "plain", "naive": "naive",
             "fp32": "plain"}
    j = 0
    for i, seg in enumerate(model.plan):
        for lp in params[f"seg{i}"]:
            same = lm._apply_block(lp, cfg, seg, xs["plain"], pos)[0]
            for name in xs:
                xs[name] = lm._apply_block(lp, cfg, seg, xs[name], pos,
                                           force=force[name])[0]
            print(f"layer {j:2d} window {seg.window}: residual rel max vs "
                  f"plain: kernel {rel(xs['kernel'], xs['plain']):.3e}, "
                  f"naive {rel(xs['naive'], xs['plain']):.3e}, fp32 "
                  f"{rel(xs['fp32'], xs['plain']):.3e}; kernel vs fp32 "
                  f"{rel(xs['kernel'], xs['fp32']):.3e}; this block on the "
                  f"same input kernel vs plain {rel(same, xs['plain']):.3e}; "
                  f"max |x| {xs['plain'].float().abs().max().item():.3e}",
                  flush=True)
            j += 1
    logits = {name: model._logits(params, layers.rmsnorm(
        params["ln_f"], x[:, -1:])) for name, x in xs.items()}
    for name in ("kernel", "naive", "fp32"):
        print(f"last-position logits {name} vs plain: "
              f"{rel(logits[name], logits['plain']):.3e}", flush=True)
    print(f"kernel vs fp32 {rel(logits['kernel'], logits['fp32']):.3e}, "
          f"plain vs fp32 {rel(logits['plain'], logits['fp32']):.3e}, naive "
          f"vs fp32 {rel(logits['naive'], logits['fp32']):.3e}", flush=True)
    # the prefill's own logits, kernel vs plain vs naive (as serve_numbers)
    got = {f: lm.build(cfg, force=f).prefill(
        params, prompts, model.init_cache(cs.BATCH, cs.PROMPT + cs.GEN, dev))
        for f in (None, "plain", "naive")}
    print(f"prefill logits kernel vs plain {rel(got[None], got['plain']):.3e}"
          f", naive vs plain {rel(got['naive'], got['plain']):.3e}, kernel "
          f"vs naive {rel(got[None], got['naive']):.3e}", flush=True)
    cache = model.init_cache(cs.BATCH, cs.PROMPT + cs.GEN, dev)
    ms = cs.time_ms(lambda: model.prefill(params, prompts, cache), 2,
                    warmup=1)
    t0 = time.perf_counter()
    rows = cs.device_kernels(lambda: model.prefill(params, prompts, cache))
    took = time.perf_counter() - t0
    cs.report_busy(f"{cfg.name} full-depth prefill (profile took {took:.1f}s)",
                   rows, ms, 1, top=12)
print(card)
