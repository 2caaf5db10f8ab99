#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every CUDA kernel from
     `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch twin on the card, over the
     masks, dtypes and shapes listed in CASES, within fp32 2e-5 / bf16 2e-2;
  3. the main path: `repro_torch.launch.serve.main` serving TinyLlama-1.1B
     at full width (batch 4, prompt 2048, 16 new tokens, random weights
     from seed 0), with every kernel's launch count read around that run;
  4. prefill logits through the kernel against those through the plain
     twin (relative max error <= 2e-2), the same model at reduced width on
     the GPU against the CPU, and timings: kernel, plain twin and
     `scaled_dot_product_attention` (a yardstick the port never calls) at
     the main path's shape, prefill ms and decode ms per token;
  5. torch.profiler's device time for one prefill and three decode steps,
     as a share of the timings above, with the heaviest kernels.
Prints one `{"kernels": [...]}` line, the card line, and last
`{"ok": true, "device": {...}}`.  Exits non-zero, without that last line,
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils._pytree import tree_map

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# (B, Sq, Skv, H, hd, causal, window, q_offset, scale)
CASES = [
    (2, 512, 512, 4, 64, True, None, 0, None),
    (2, 512, 512, 4, 64, False, None, 0, None),
    (2, 512, 512, 4, 64, True, 128, 0, None),
    (1, 512, 512, 2, 128, True, None, 0, None),
    (1, 128, 256, 2, 64, True, None, 128, None),
    (2, 256, 256, 4, 64, True, None, 0, 0.3),
    (1, 2100, 2100, 2, 64, True, None, 0, None),
    (4, 2048, 2048, 32, 64, True, None, 0, None),   # the main path's shape
]
MAIN = CASES[-1]
ARCH, BATCH, PROMPT, GEN = "tinyllama-1.1b", 4, 2048, 16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> list:
    """torch.profiler's CUDA-side rows (kernels and copies) for one call of
    fn; empty if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def report_busy(label: str, rows: list, wall_ms: float, per: int) -> None:
    """Device-busy share of a phase: profiled kernel time over the phase's
    unprofiled time (both per call), plus the heaviest kernels."""
    if not rows:
        print(f"{label}: device time not measured (no CUDA profiler events)")
        return
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / per
    launches = sum(e.count for e in rows) / per
    print(f"{label}: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f} %), {launches:.0f} device "
          "kernels/copies per call", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / per:9.3f} ms "
              f"x{e.count // per:<5d} {e.key[:90]}")


def qkv(case, dtype, seed=0):
    b, sq, skv, h, hd = case[:5]
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, h, hd, generator=g, device="cuda").to(dtype)
                 for s in (sq, skv, skv))


def attn_kwargs(case):
    causal, window, q_offset, scale = case[5:]
    return dict(causal=causal, window=window, q_offset=q_offset, scale=scale)


def bound(case, dtype) -> tuple[float, str]:
    """Least time (ms) for the card: each input read and the output written
    once, against the visible (q, k) pairs' QK^T and PV operations."""
    b, sq, skv, h, hd = case[:5]
    causal, window, q_offset, _ = case[5:]
    q_pos = torch.arange(sq, dtype=torch.int64)[:, None] + q_offset
    k_pos = torch.arange(skv, dtype=torch.int64)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    flops = 4.0 * b * h * hd * int(vis.sum())
    nbytes = (2 * b * sq + 2 * b * skv) * h * hd * dtype.itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(fa) -> float:
    """Phase 2; returns the max abs error at the main path's shape, bf16."""
    main_err = None
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(case, dtype)
            kw = attn_kwargs(case)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.isfinite(got).all().item() and err <= TOL[dtype]
            print(json.dumps({"case": list(case), "dtype": str(dtype),
                              "max_abs_err": err, "tol": TOL[dtype],
                              "ok": ok}), flush=True)
            if not ok:
                fail(f"flash_attention {case} {dtype}: error {err}")
            if case is MAIN and dtype == torch.bfloat16:
                main_err = err
            del q, k, v, got, want
    return main_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as configs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import lm

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in built:
        for line in build.log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. kernels against their plain twins
    main_err = check_kernels(fa)

    # 3. the main path, counted
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    toks = serve.main(["--arch", ARCH, "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    cfg = configs.get(ARCH)
    print(f"serve {ARCH}: {serve_s:.3f}s end to end (weights init included), "
          f"flash_attention launches {launches} [{card}]", flush=True)
    if launches != cfg.n_layers:
        fail(f"flash_attention launched {launches} times in the serve run; "
             f"want one per layer ({cfg.n_layers})")
    if toks.shape != (BATCH, GEN) or not (0 <= int(toks.min())
                                          and int(toks.max()) < cfg.vocab):
        fail(f"serve tokens {tuple(toks.shape)} out of range")
    del toks

    # 4a. kernel timings at the main path's shape
    q, k, v = qkv(MAIN, torch.bfloat16)
    kw = attn_kwargs(MAIN)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    bound_ms, bound_by = bound(MAIN, torch.bfloat16)
    print(f"flash_attention {MAIN[:5]} bf16 causal: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    del q, k, v, qt, kt, vt

    # 4b. prefill through the kernel vs the plain twin; decode timing
    model = lm.build(cfg)
    plain = lm.build(cfg, attn_force="plain")
    dev = torch.device("cuda")
    params = model.init(torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    with torch.inference_mode():
        cache = model.init_cache(BATCH, PROMPT + GEN, dev)
        before = fa.flash_attention.launches
        got = model.prefill(params, prompts, cache)
        torch.cuda.synchronize()
        if fa.flash_attention.launches - before != cfg.n_layers:
            fail("prefill did not launch the kernel once per layer")
        want = plain.prefill(params, prompts,
                             plain.init_cache(BATCH, PROMPT + GEN, dev))
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"prefill logits kernel vs plain: rel max err {rel:.3e}",
              flush=True)
        if not (torch.isfinite(got).all().item() and rel <= 2e-2):
            fail(f"prefill logits through the kernel differ from plain: {rel}")

        prefill_ms = time_ms(lambda: model.prefill(params, prompts, cache), 3,
                             warmup=1)
        plain_prefill_ms = time_ms(
            lambda: plain.prefill(params, prompts, cache), 2, warmup=1)
        tok = got[:, -1].argmax(dim=-1, keepdim=True)
        model.prefill(params, prompts, cache)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(GEN - 1):
            tok = model.decode_step(params, tok, cache, PROMPT + i)[:, -1] \
                .argmax(dim=-1, keepdim=True)
        end.record()
        end.synchronize()
        decode_ms = start.elapsed_time(end) / (GEN - 1)
        print(f"prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms through the "
              f"kernel, {plain_prefill_ms:.3f} ms through the plain twin; "
              f"decode {decode_ms:.3f} ms/token, "
              f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH} "
              f"[{card}]", flush=True)

        # 5. where the time goes: profiled device time against the above
        report_busy("prefill", device_kernels(
            lambda: model.prefill(params, prompts, cache)), prefill_ms, 1)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + i)
        report_busy("decode step", device_kernels(three_steps), decode_ms, 3)
    del params, cache, got, want

    # 4c. the reduced model on the GPU against the CPU (non-kernel layers)
    small = configs.get(ARCH, reduced=True)
    sm = lm.build(small)
    sp = sm.init(torch.Generator("cpu").manual_seed(0))
    stoks = torch.randint(0, small.vocab, (2, 64),
                          generator=torch.Generator("cpu").manual_seed(2))
    cpu_logits = sm.forward(sp, stoks)
    sp_gpu = tree_map(lambda t: t.to(dev), sp)
    gpu_logits = sm.forward(sp_gpu, stoks.to(dev)).cpu()
    rel_small = ((gpu_logits - cpu_logits).abs().max()
                 / cpu_logits.abs().max()).item()
    print(f"reduced {small.name} forward, GPU vs CPU: rel max err "
          f"{rel_small:.3e}", flush=True)
    if rel_small > 2e-2:
        fail(f"reduced forward on the GPU differs from the CPU: {rel_small}")

    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": launches, "max_abs_err": main_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
