#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every CUDA kernel from
     `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel)
     and print ptxas's registers and spills per kernel and its warning and
     C75xx lines (fatal for a tensor-core kernel that spills or has its
     wgmma serialized);
  2. each kernel against its plain PyTorch twin on the card, over the
     masks, dtypes, head dims (16, 32, 64, 128, 256) and shapes listed in
     CASES (with the tile edges of the bf16 hd-256 kernel) and on strided
     k and v at hd 64, 128 and 256: the flash forward within fp32 2e-5 /
     bf16 2e-2 (max abs), its lse within 1e-4 (relative max); the flash
     backward's dq, dk and dv against autograd of the plain twin within
     fp32 2e-5 / bf16 2e-2 (relative max), on rows that see a key (a case
     with rows that see none checks that the kernel's dq stays finite
     there), over CASES and the wgmma backward's own tile edges at hd 64,
     128 and 256 (BWD_EDGES), and two backward calls bitwise equal at the
     main shape, at hd 128 and at Gemma-7B's training shape (2, 2048, 16,
     256); wkv6 over WKV_CASES (one with rows that take the
     kernel's 4-byte copy path) and a state-carry case, y and the final
     state within |got - want| <= 1e-4 + 1e-4 |want| elementwise, the main
     shape included;
  3. the main paths, each with every kernel's launch count set to 0 just
     before and read just after: `repro_torch.launch.serve.main` serving
     TinyLlama-1.1B, RWKV6-3B and, last, Gemma-7B (head dim 256: exactly
     28 flash forwards) at full width (batch 4, prompt 2048, 16 new tokens,
     random weights from seed 0), and
     `repro_torch.launch.train.build_trainer`'s step training
     TinyLlama-1.1B at full width (batch 4, seq 2048, fp32 masters,
     remat "full", 3 steps after a warm-up: exactly 44 flash forwards and
     22 flash backwards a step; step ms, tokens/s, peak memory, finite
     losses), then one step through the kernels against one through the
     plain twins from the same params and batch, and the reduced dense
     configs at 2048 tokens (forward and one train step) through the
     kernels; last, after the Gemma-7B serve, the same training phase on
     Gemma-7B at full width (every published width; its one reduction is
     depth, 6 of 28 layers, GEMMA_TRAIN_LAYERS, as fp32 masters with
     AdamW for all 28 need ~136 GB) at batch 2 x seq 2048: exactly 12
     flash forwards and 6 flash backwards (head dim 256) a step;
  4. per model: prefill logits through the kernel against those through
     the plain twin (relative max error <= 2e-2; for RWKV6-3B each block on
     the same input, and the logits within max(2e-2, 1.5 x the plain
     twin's distance from a float64 recurrence)), the same model at reduced
     width on the GPU against the CPU, and timings: kernel and plain twin
     (and for flash attention `scaled_dot_product_attention`, a yardstick
     the port never calls, and the achieved TFLOP/s) at the main path's
     shape, for flash attention also at hd 128 (4, 2048, 40, 128) and
     Gemma-7B's hd 256 (2, 2048, 16, 256) and, in the Gemma-7B phase, at
     the shape its prefill gives the kernel (4, 2048, 16, 256), for the
     flash backward beside SDPA's backward (also at hd 128, and in the
     Gemma-7B phase at its training shape (2, 2048, 16, 256)) with the
     profiler's device time of each of its three launches (at the main
     shape and at hd 256), for wkv6 also the decode step's
     call (4, 1, 40, 64) (device time from the profiler), prefill ms and
     decode ms per token;
  5. torch.profiler's device time for one prefill (with the flash
     forward's share), three decode steps and one training step of each
     trained model, as a share of the timings above, with the heaviest
     kernels (and the flash backward's share of the step);
  6. last, with the card's memory released, the float64 DeepNVM++
     pipeline (`repro_torch.core`, no hand-written kernel) on `cuda`: the
     16 nm Table II designs at 3 MB against the scalar path
     (`evaluate_scalar`, `tune_loop`; equal orgs, 1e-12 relative), all
     five Table II columns against the JAX reference's numbers
     (PIPELINE_GOLDEN, pinned by tests/test_torch_pipeline.py) and the 3
     MB anchor error against the reference's (~3.5e-4); the iso-area
     capacities (7 / 10 MB), the isocap and iso-area summaries and the
     scaling headline against the reference's numbers (1e-12); then the
     full mega spec (104,832 cells) through `sweep.run` cold, warm (three
     runs, each after dropping the sweep, fold and circuit-table memos)
     and `run_sharded` with ShardPlan(64, 288) at devices None and 1,
     and on this machine's CPU: every result's rows within 1e-12 of the
     warm run's, with equal tuned orgs; seconds, cells/s, peak memory and
     the warm run's device-busy share, printed as a `{"pipeline": ...}`
     line.
Prints one `{"kernels": [...]}` line, the `{"pipeline": ...}` line, the
card line, and last `{"ok": true, "device": {...}}`.  Exits non-zero,
without that last line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves, tree_map

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
    # the edges of the bf16 kernel's 128-row q and 64 / 128-key kv tiles
    (2, 1, 1, 3, 64, True, None, 0, None),
    (2, 127, 127, 3, 64, True, None, 0, None),
    (2, 129, 129, 3, 128, True, None, 0, None),
    (2, 255, 255, 3, 64, True, None, 0, None),
    (2, 129, 255, 3, 64, False, None, 0, None),
    (2, 127, 255, 3, 64, True, None, 128, None),     # Sq < Skv, q_offset
    (2, 1, 255, 3, 128, True, None, 254, None),      # one query, cache end
    (2, 300, 300, 3, 64, True, 100, 0, None),        # window ends in a tile
    (2, 255, 311, 3, 128, True, 200, 56, 0.2),
    (2, 129, 64, 3, 128, False, None, 0, 0.2),       # Skv below one kv tile
    (2, 129, 100, 3, 64, True, None, 64, None),
    # head dims 16 and 32 (the SIMT path in bf16 too: 64-row q tiles,
    # 32-key kv tiles), hd 256 in fp32 (SIMT: 32-row q tiles, 16-key kv
    # tiles), and the masks
    (2, 512, 512, 4, 16, True, None, 0, None),
    (2, 512, 512, 4, 32, False, None, 0, 0.3),
    (1, 512, 512, 2, 256, True, 128, 0, None),
    (2, 65, 33, 3, 16, False, None, 0, None),
    (2, 127, 129, 3, 32, True, None, 2, None),
    (2, 33, 47, 3, 256, True, None, 14, 0.2),
    (2, 300, 300, 3, 32, True, 100, 0, None),
    (1, 300, 100, 2, 64, True, 50, 0, None),      # rows past 148 see no key
    # the edges of the bf16 hd-256 kernel's 128-row q and 64-key kv tiles
    (2, 127, 127, 3, 256, True, None, 0, None),
    (2, 128, 128, 3, 256, True, None, 0, None),
    (2, 129, 129, 3, 256, True, None, 0, None),
    (2, 128, 63, 3, 256, False, None, 0, None),
    (2, 129, 64, 3, 256, False, None, 0, 0.2),       # a non-default scale
    (2, 127, 65, 3, 256, True, None, 0, None),
    (2, 65, 129, 3, 256, True, None, 64, None),      # Sq < Skv, q_offset
    (2, 1, 65, 3, 256, True, None, 64, None),        # one query, cache end
    (2, 129, 129, 3, 256, True, 40, 0, None),        # window ends in a tile
    (2, 127, 63, 3, 256, True, 30, 0, None),         # rows past 92 see none
    (2, 2048, 2048, 16, 256, True, None, 0, None),  # Gemma-7B's heads
    (4, 2048, 2048, 16, 256, True, None, 0, None),  # Gemma-7B's prefill
    (4, 2048, 2048, 32, 64, True, None, 0, None),   # the main path's shape
]
MAIN = CASES[-1]
GEMMA = CASES[-2]      # the shape the Gemma-7B serve gives the kernel
GEMMA_B2 = CASES[-3]   # the same heads at batch 2
# The backward's own edges, bf16 at hd 64, 128 and 256 (the wgmma
# kernels): its 128- (hd 64) or 64-row (hd 128, 256) q steps and 128-key
# (64 at hd 256) tiles (dK / dV), its 128-row q tiles and 64-key tiles
# (dQ), at 63 / 64 / 65 / 127 / 128 / 129; rings that wrap (three q steps,
# five key tiles: hd 256 has 2 stages of Q and dO, and 2 of K and 1 of V in
# dQ); causal with q_offset, a window that ends inside a tile, rows that
# see no key.
BWD_EDGES = [(2, sq, skv, 3, hd, causal, window, q_offset, scale)
             for hd in (64, 128, 256)
             for sq, skv, causal, window, q_offset, scale in [
                 (63, 63, True, None, 0, None),
                 (64, 64, True, None, 0, None),
                 (65, 65, True, None, 0, None),
                 (127, 129, False, None, 0, None),
                 (128, 128, True, None, 0, 0.2),
                 (129, 129, True, None, 0, None),
                 (65, 129, True, None, 64, None),    # Sq < Skv, q_offset
                 (128, 129, True, None, 1, None),
                 (129, 63, False, None, 0, None),
                 (129, 65, True, 40, 0, None),       # window ends in a tile
                 (127, 63, True, 30, 0, None),       # rows past 92 see none
                 (64, 127, True, 100, 28, None),
                 (192, 192, True, None, 0, None),    # three q steps
                 (129, 257, False, None, 0, None)]]  # five key tiles and one
# Qwen3-14B's head layout (40 heads of 128), timed beside the main shape
HD128 = (4, 2048, 2048, 40, 128, True, None, 0, None)
BWD_PARTS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
DENSE = ["tinyllama-1.1b", "qwen3-14b", "gemma-7b", "minicpm-2b"]
TRAIN_STEPS = 3
# Gemma-7B trained at every published width, its depth cut to what one
# 80 GB card holds: 2.45 B fp32 params with grads, m and v ~39 GB, and the
# fp32 logits of 2 x 2048 tokens over 256000 entries 4.2 GB a copy
GEMMA_TRAIN_LAYERS = 6
GEMMA_TRAIN_BATCH = 2
# Relative L2 error per gradient leaf of a training step, kernels against
# plain twins from the same params and batch.  Activations are bf16, so
# the two differ by where bf16 rounds: measured on the H100 for
# TinyLlama-1.1B 1.9e-2 (median) and 2.3e-2 (worst of 201 leaves), for
# Gemma-7B at 6 layers 1.2e-2 and 2.0e-2 (of 56); on the CPU the
# port's own gradients move by up to 2.0e-2 between bf16 and fp32
# activations (reduced TinyLlama).  The bar is about twice that noise.
GRAD_BAR = 5e-2
ARCH, BATCH, PROMPT, GEN = "tinyllama-1.1b", 4, 2048, 16
GEMMA_ARCH = "gemma-7b"   # the head-dim-256 serving path
RWKV_ARCH = "rwkv6-3b"
# (B, S, H, hd, chunk, decay, with_s0, pad): w = exp(-exp(decay + 0.5 N));
# pad > 0 lays r, k, v, w out one element into a wider buffer with a token
# stride of H*hd + pad elements (the kernel's 4-byte copy path)
WKV_DECODE = (4, 1, 40, 64, 32, -3.0, True, 0)    # one decode step
WKV_CASES = [
    (1, 128, 2, 32, 32, -3.0, False, 0),
    (1, 128, 2, 32, 64, -3.0, False, 0),
    (2, 256, 4, 64, 32, -3.0, False, 0),
    (2, 256, 4, 64, 64, -3.0, False, 0),
    (1, 2100, 2, 64, 64, -3.0, False, 0),      # ragged last chunk
    WKV_DECODE,
    (2, 256, 4, 16, 32, -3.0, True, 0),
    (2, 256, 4, 128, 32, -3.0, True, 0),
    (2, 256, 4, 64, 64, 2.0, False, 0),        # strong decay
    (2, 300, 40, 64, 32, -3.0, True, 1),       # misaligned rows
    (4, 2048, 40, 64, 32, -3.0, True, 0),      # the main path's shape
]
WKV_MAIN = WKV_CASES[-1]

# The float64 DeepNVM++ pipeline (phase 6).  Its bar: 1e-12 relative, the
# one the reference holds between its own scalar and batched paths.  The
# analyses are held to the JAX reference's numbers (this machine has no
# JAX); tests/test_torch_pipeline.py pins these constants to
# `repro.core` on the CPU.
PIPELINE_REL = 1e-12
# The Table II 3 MB anchor error (as benchmarks/table2_cache.py computes
# it, ~3.5e-4 of a leakage / area anchor): a difference of two values that
# agree to 1e-12 relative, divided by the 3.5e-4 gap, so ~3e-9 relative.
ANCHOR_ERR_REL = 1e-8
MEGA_PLAN = dict(scenario_chunk=64, design_chunk=288)
PIPELINE_GOLDEN = {
    "table2": {
        "sram": {
            "capacity_bytes": 3145728,
            "org": "1b x 128r x 256c / sequential",
            "read_latency_s": 2.9100000000000005e-09,
            "write_latency_s": 1.53e-09,
            "read_energy_j": 3.4999999999999993e-10,
            "write_energy_j": 3.2000000000000003e-10,
            "leakage_w": 6.442749179585304,
            "area_mm2": 5.531051665241455,
        },
        "stt": {
            "capacity_bytes": 3145728,
            "org": "1b x 128r x 256c / sequential",
            "read_latency_s": 2.9799999999999996e-09,
            "write_latency_s": 9.31e-09,
            "read_energy_j": 8.100000000000001e-10,
            "write_energy_j": 3.1e-10,
            "leakage_w": 0.7479188256318854,
            "area_mm2": 2.340150966085292,
        },
        "sot": {
            "capacity_bytes": 3145728,
            "org": "1b x 128r x 256c / sequential",
            "read_latency_s": 3.7100000000000002e-09,
            "write_latency_s": 1.38e-09,
            "read_energy_j": 4.900000000000001e-10,
            "write_energy_j": 2.2000000000000002e-10,
            "leakage_w": 0.5271832675931994,
            "area_mm2": 1.950000577897137,
        },
        "stt_isoarea": {
            "capacity_bytes": 7340032,
            "org": "1b x 128r x 256c / sequential",
            "read_latency_s": 3.3284014911279853e-09,
            "write_latency_s": 9.599874115459549e-09,
            "read_energy_j": 9.307037715129982e-10,
            "write_energy_j": 3.262352827822285e-10,
            "leakage_w": 1.7059247403657152,
            "area_mm2": 5.120080454437546,
        },
        "sot_isoarea": {
            "capacity_bytes": 10485760,
            "org": "1b x 128r x 256c / sequential",
            "read_latency_s": 4.301232253914615e-09,
            "write_latency_s": 1.7801081683908728e-09,
            "read_energy_j": 6.821705102042964e-10,
            "write_energy_j": 2.9462996334119443e-10,
            "leakage_w": 1.4350523897287781,
            "area_mm2": 5.6401255233758,
        },
    },
    "isocap_summary": {
        "stt": {
            "dyn_energy_x": 1.989317166313483,
            "leak_reduction": 5.665142743167122,
            "energy_reduction": 4.086573451307579,
            "edp_reduction_mean": 2.039023276904304,
            "edp_reduction_max": 2.2886331945764304,
        },
        "sot": {
            "dyn_energy_x": 1.2279197735356069,
            "leak_reduction": 10.702336596785225,
            "energy_reduction": 7.361689256062841,
            "edp_reduction_mean": 3.928245112046117,
            "edp_reduction_max": 4.353989350856196,
        },
        "sram": {
            "read_share_of_dyn": 0.758483892681553,
        },
    },
    "isoarea_capacities_mb": {
        "stt": 7,
        "sot": 10,
    },
    "isoarea_summary": {
        "stt": {
            "dyn_energy_x": 2.2631473098643746,
            "leak_reduction": 2.3814603506716128,
            "energy_reduction": 2.043420641000703,
            "edp_reduction_no_dram": 1.2942183471263013,
            "edp_reduction_with_dram": 1.2239480952841941,
        },
        "sot": {
            "dyn_energy_x": 1.700697935202507,
            "leak_reduction": 3.586696408583049,
            "energy_reduction": 3.0124908434596938,
            "edp_reduction_no_dram": 2.4076075292345234,
            "edp_reduction_with_dram": 2.2105145436605595,
        },
    },
    "scaling_headline": {
        "stt": {
            "energy_reduction_max": 20.84814970876544,
            "latency_reduction_max": 1.5493019488154027,
            "edp_reduction_max": 31.463051769092182,
        },
        "sot": {
            "energy_reduction_max": 46.92869299418143,
            "latency_reduction_max": 1.931271867702876,
            "edp_reduction_max": 86.45868136499293,
        },
    },
    "table2_anchor_max_rel_err": 0.0003477563438318577,
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, C75xx lines) per entry function
    of an `nvcc -Xptxas -v` log; the kernel as name<template args>."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"(?<=\d)(flash_[a-z0-9_]+?|wkv6_kernel)I",
                             mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            dt = ("bf16" if "__nv_bfloat16" in mangled else "f32"
                  if re.search(r"ILi\d+EfE", mangled) else "")
            cur = {"kernel": f"{name.group(1) if name else mangled}<"
                             f"{', '.join(args + ([dt] if dt else []))}>",
                   "mangled": mangled, "registers": None, "spill": None,
                   "c75": []}
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = int(re.search(r"(\d+) bytes spill stores",
                                         line).group(1))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    for line in log.splitlines():   # C75xx lines name their function
        if "(C75" in line:
            for row in rows:
                if row["mangled"] in line:
                    row["c75"].append(line.strip())
    return rows


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


def kernel_device_ms(fn, name: str, calls: int = 50):
    """Mean device time (ms) of the device kernels whose name holds `name`,
    over `calls` calls of fn, from torch.profiler; None where it saw none."""
    rows = [e for e in device_kernels(lambda: [fn() for _ in range(calls)])
            if name in e.key]
    if not rows:
        return None
    return (sum(e.self_device_time_total for e in rows) / 1e3
            / sum(e.count for e in rows))


def report_busy(label: str, rows: list, wall_ms: float, per: int,
                top: int = 6) -> None:
    """Device-busy share of a phase: profiled kernel time over the phase's
    unprofiled time (both per call), plus the `top` heaviest kernels."""
    if not rows:
        print(f"{label}: device time not measured (no CUDA profiler events)")
        return
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / per
    launches = sum(e.count for e in rows) / per
    print(f"{label}: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f} %), {launches:.0f} device "
          "kernels/copies per call", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
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


def attn_flops(case) -> float:
    """The QK^T and PV operations of the visible (q, k) pairs."""
    b, sq, skv, h, hd = case[:5]
    causal, window, q_offset, _ = case[5:]
    q_pos = torch.arange(sq, dtype=torch.int64)[:, None] + q_offset
    k_pos = torch.arange(skv, dtype=torch.int64)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return 4.0 * b * h * hd * int(vis.sum())


def roofline(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The larger of the operations' time at `peak` FLOP/s and the bytes'
    at PEAK_BYTES, in ms, and which one it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(case, dtype) -> tuple[float, str]:
    """Least time (ms) for the card: each input read and the output written
    once, against the visible (q, k) pairs' QK^T and PV operations."""
    b, sq, skv, h, hd = case[:5]
    flops = attn_flops(case)
    nbytes = (2 * b * sq + 2 * b * skv) * h * hd * dtype.itemsize
    return roofline(flops, nbytes, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_F32_FLOPS)


def seen_rows(case):
    """(Sq,) bool on the card: the query rows that see at least one key."""
    _, sq, skv, _, _, causal, window, q_offset, _ = case
    q_pos = torch.arange(sq, device="cuda")[:, None] + q_offset
    k_pos = torch.arange(skv, device="cuda")[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool, device="cuda")
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return vis.any(dim=1)


def rel_err(got, want, floor: float = 1e-30) -> float:
    """max |got - want| over max(max |want|, floor)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(floor)).item()


def check_backward(fa, case, dtype, q, k, v, seen) -> float:
    """Phase 2 for the backward kernel at one case: dq, dk, dv against
    autograd of the plain twin on the same q, k, v and dO (dO zero on rows
    that see no key, where the two differ by design), and the kernel's dq
    finite with a dO that is not.  Errors are relative to max(max |want|,
    1): a gradient can be 0 by cancellation (at Sq = Skv = 1 the one key
    has p = 1, so ds = dO.v - delta = 0 and dq = dk = 0), and there a ratio
    of two rounding residues says nothing.  Returns the worst relative max error and
    the worst max abs error."""
    kw = attn_kwargs(case)
    g = torch.Generator("cuda").manual_seed(7)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    do_seen = do * seen[None, :, None, None]
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, do_seen, lse, **kw)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, **kw).backward(do_seen)
    errs = [rel_err(a, b.grad, floor=1.0) for a, b in zip(got, (qr, kr, vr))]
    abs_err = max((a.float() - b.grad.float()).abs().max().item()
                  for a, b in zip(got, (qr, kr, vr)))
    finite = all(torch.isfinite(t).all().item() for t in got)
    if not seen.all():
        dq_full = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)[0]
        finite = finite and torch.isfinite(dq_full).all().item()
    torch.cuda.synchronize()
    ok = finite and max(errs) <= TOL[dtype]
    print(json.dumps({"bwd_case": list(case), "dtype": str(dtype),
                      "rel_max_err_dq_dk_dv": errs, "tol": TOL[dtype],
                      "finite": finite, "ok": ok}), flush=True)
    if not ok:
        fail(f"flash_attention_bwd {case} {dtype}: errors {errs}, finite "
             f"{finite}")
    return max(errs), abs_err


def check_forward(fa, ref, case, dtype, q, k, v, seen) -> float:
    """Phase 2 for the forward kernel at one case: the output within
    TOL[dtype] (max abs) and lse within 1e-4 (relative max) of the plain
    twin's, on rows that see a key.  Returns the max abs error."""
    kw = attn_kwargs(case)
    got, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    want, want_lse = ref.flash_fwd(q, k, v, min(512, case[2]), **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float())[:, seen].abs().max().item()
    lse_err = rel_err(lse[:, :, seen], want_lse[:, :, seen])
    ok = (torch.isfinite(got).all().item() and err <= TOL[dtype]
          and lse_err <= 1e-4)
    print(json.dumps({"case": list(case), "dtype": str(dtype),
                      "max_abs_err": err, "tol": TOL[dtype],
                      "lse_rel_max_err": lse_err, "lse_tol": 1e-4,
                      "ok": ok}), flush=True)
    if not ok:
        fail(f"flash_attention {case} {dtype}: error {err}, lse {lse_err}")
    return err


def check_kernels(fa, ref) -> dict:
    """Phase 2 for flash attention, forward (output and lse) and backward;
    returns {case: (forward max abs error, backward max abs error)} for
    bf16 at the main path's shape and at Gemma-7B's serve and training
    shapes."""
    errs = {}
    for case in CASES:
        seen = seen_rows(case)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(case, dtype)
            err = check_forward(fa, ref, case, dtype, q, k, v, seen)
            _, bwd_err = check_backward(fa, case, dtype, q, k, v, seen)
            if case in (MAIN, GEMMA, GEMMA_B2) and dtype == torch.bfloat16:
                errs[case] = (err, bwd_err)
            del q, k, v
    # strided k and v: every other head of wider tensors, token slices of
    # them
    for hd in (64, 128, 256):
        case = (2, 200, 200, 2, hd, True, None, 0, None)
        q, _, _ = qkv(case, torch.bfloat16)
        _, k_wide, v_wide = qkv((2, 1, 272, 4, hd) + case[5:], torch.bfloat16,
                                seed=1)
        k, v = k_wide[:, 72:, ::2], v_wide[:, :200, 1::2]
        if k.is_contiguous() or v.is_contiguous():
            fail("the strided case is not strided")
        print(f"strided k / v, hd {hd}:", flush=True)
        seen = seen_rows(case)
        check_forward(fa, ref, case, torch.bfloat16, q, k, v, seen)
        check_backward(fa, case, torch.bfloat16, q, k, v, seen)
    print("the backward's wgmma tile edges:", flush=True)
    for case in BWD_EDGES:
        q, k, v = qkv(case, torch.bfloat16)
        check_backward(fa, case, torch.bfloat16, q, k, v, seen_rows(case))
    for case in (MAIN, HD128, GEMMA_B2):
        check_deterministic(fa, case)
    return errs


def bwd_inputs(fa, case) -> tuple:
    """The backward's bf16 arguments at one case: q, k, v, the forward's
    output and lse, and dO ~ N(0, 1), with the case's mask keywords."""
    q, k, v = qkv(case, torch.bfloat16)
    kw = attn_kwargs(case)
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(7),
                     device="cuda").bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    return (q, k, v, out, do, lse), kw


def check_deterministic(fa, case) -> None:
    """Phase 2: two backward calls on the same bf16 inputs give bitwise
    equal dq, dk and dv (the kernels use no atomics)."""
    args, kw = bwd_inputs(fa, case)
    first = fa.flash_attention_bwd(*args, **kw)
    second = fa.flash_attention_bwd(*args, **kw)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(json.dumps({"bwd_deterministic": list(case),
                      "bitwise_equal_dq_dk_dv": same}), flush=True)
    if not all(same):
        fail(f"flash_attention_bwd {case}: two calls differ ({same})")


def time_flash(fa, case, card) -> tuple:
    """Phase 4a for one causal bf16 shape: the kernel, its plain twin and
    `scaled_dot_product_attention` (a yardstick the port never calls) on the
    same inputs, with the bound and the achieved TFLOP/s on the visible
    pairs.  Returns (ms, plain_ms, sdpa_ms, bound_ms, bound_by)."""
    q, k, v = qkv(case, torch.bfloat16)
    kw = attn_kwargs(case)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    bound_ms, bound_by = bound(case, torch.bfloat16)
    tflops = attn_flops(case) / 1e9
    print(f"flash_attention {case[:5]} bf16 causal: kernel {ms:.4f} ms "
          f"({tflops / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms ({tflops / lib_ms:.1f} TFLOP/s), bound "
          f"{bound_ms:.4f} ms ({bound_by}, {tflops:.1f} GFLOP) [{card}]",
          flush=True)
    return ms, plain_ms, lib_ms, bound_ms, bound_by


def bwd_bound(case, dtype) -> tuple[float, str]:
    """Least time (ms) for the backward: q, k, v, o, dO and lse read and
    dq, dk, dv written once, against the five products over the visible
    pairs (S, dP, dQ, dK, dV: 2.5 x the forward's two)."""
    b, sq, skv, h, hd = case[:5]
    flops = 2.5 * attn_flops(case)
    nbytes = (4 * b * sq + 4 * b * skv) * h * hd * dtype.itemsize \
        + 4 * b * h * sq
    return roofline(flops, nbytes, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_F32_FLOPS)


def time_flash_bwd(fa, ref, case, card) -> tuple:
    """Phase 4a for the backward at one causal bf16 shape: the kernel (its
    three launches), its plain twin and SDPA's backward (SDPA forward and
    backward less its forward; a yardstick the port never calls) on the
    same inputs, with the bound.  Returns (ms, plain_ms, sdpa_ms, bound_ms,
    bound_by)."""
    args, kw = bwd_inputs(fa, case)
    q, k, v, out, do, lse = args
    ms = time_ms(lambda: fa.flash_attention_bwd(*args, **kw), 5)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_plain(
        q, k, v, out, do, lse, min(512, case[2]), **kw), 3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                      20)
    lib_ms = both_ms - time_ms(sdpa, 20)
    bound_ms, bound_by = bwd_bound(case, torch.bfloat16)
    tflops = 2.5 * attn_flops(case) / 1e9
    print(f"flash_attention_bwd {case[:5]} bf16 causal: kernel {ms:.4f} ms "
          f"({tflops / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
          f"backward {lib_ms:.4f} ms (forward + backward {both_ms:.4f}), "
          f"bound {bound_ms:.4f} ms ({bound_by}, {tflops:.1f} GFLOP) [{card}]",
          flush=True)
    return ms, plain_ms, lib_ms, bound_ms, bound_by


def bwd_parts(fa, case, card) -> None:
    """Phase 4a: torch.profiler's device time of each of the backward's
    three launches (delta, dK / dV, dQ) at one causal bf16 shape."""
    args, kw = bwd_inputs(fa, case)
    rows = device_kernels(lambda: [fa.flash_attention_bwd(*args, **kw)
                                   for _ in range(10)])
    parts = []
    for name in BWD_PARTS:
        hit = [e for e in rows if name in e.key]
        ms = (sum(e.self_device_time_total for e in hit) / 1e3
              / max(1, sum(e.count for e in hit)))
        parts.append(f"{name} {ms:.4f} ms" if hit
                     else f"{name} not measured")
    print(f"flash_attention_bwd {case[:5]} bf16 causal, device time per "
          f"launch (profiler): {', '.join(parts)} [{card}]", flush=True)


def train_batches(cfg, n: int, batch: int = BATCH, seq: int = PROMPT) -> list:
    """Batches 0..n-1 of the training data pipeline, on the card."""
    from repro_torch.data import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    return [{k: torch.from_numpy(a).to("cuda", torch.long)
             for k, a in data.batch(i).items()} for i in range(n)]


def set_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def train_path(card, cfg, batch: int, train, counters) -> dict:
    """Phase 3 for training: `build_trainer` on `cfg` at batch x PROMPT, a
    warm-up step, then TRAIN_STEPS steps, each with the counts set to 0
    just before it and read just after (and checked).  Returns the numbers
    for the report: the median step time and one step's launches, as the
    serve phases report one serve's."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, step, _ = train.build_trainer(cfg, device="cuda", remat="full")
    batches = train_batches(cfg, TRAIN_STEPS + 2, batch)
    state, m = step(state, batches[0])
    losses = [float(m["loss"])]
    setup_s = time.perf_counter() - t0
    times, per_step = [], []
    for b in batches[1:TRAIN_STEPS + 1]:
        set_counts(counters)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))   # waits for the device
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_counts(counters))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sorted(times)[len(times) // 2]
    print(f"train {cfg.name} ({cfg.n_layers} layers) batch {batch} x seq "
          f"{PROMPT}, fp32 masters, remat full: setup and warm-up step "
          f"{setup_s:.3f}s; steps {', '.join(f'{t:.3f}' for t in times)} ms "
          f"(median {step_ms:.3f} ms, {batch * PROMPT * 1e3 / step_ms:.1f} "
          f"tokens/s); peak memory {peak_gb:.3f} GB; losses {losses}; "
          f"launches per step {per_step} [{card}]", flush=True)
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers, "wkv6": 0}
    if any(n != want for n in per_step):
        fail(f"train {cfg.name} launched {per_step}; want {want} a step (a "
             "forward per layer, its recompute, and a backward per layer)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {cfg.name}: a loss is not finite: {losses}")
    rows = device_kernels(lambda: step(state, batches[-1]))
    report_busy(f"{cfg.name} train step", rows, step_ms, 1, top=12)
    bwd_rows = [e for e in rows if "flash_bwd" in e.key]
    if bwd_rows:   # the flash backward's share of the step, by launch
        bwd_ms = sum(e.self_device_time_total for e in bwd_rows) / 1e3
        print(f"{cfg.name} train step: the flash backward {bwd_ms:.3f} ms "
              f"of device time, {100 * bwd_ms / step_ms:.1f} % of the "
              f"{step_ms:.3f} ms step (" + ", ".join(
                  f"{re.search(r'flash_bwd_[a-z_0-9]+(<[^>]*>)?', e.key)[0]} "
                  f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in bwd_rows) + f") [{card}]", flush=True)
    del state
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "launches": per_step[0]}


def train_vs_plain(card, cfg, batch_size: int, lm) -> None:
    """Phase 4 for training: from the same fp32 params and batch, the loss
    and every gradient leaf of one step of `cfg` through the kernels
    against the same through the plain twins (autograd of
    `ref.flash_attention_ref`).  The loss within 2e-2 relative; each
    leaf's relative L2 error within GRAD_BAR (see there)."""
    params = lm.build(cfg).init(torch.Generator("cuda").manual_seed(0),
                                dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = train_batches(cfg, 1, batch_size)[0]
    got = {}
    for force in (None, "plain"):
        loss = lm.build(cfg, force=force, remat="full").loss(params, batch)
        got[force] = (loss.item(), torch.autograd.grad(loss, leaves))
    (loss_k, gk), (loss_p, gp) = got[None], got["plain"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    l2 = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
          for a, b in zip(gk, gp)]
    worst = max(range(len(l2)), key=l2.__getitem__)
    print(f"{cfg.name} train step kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} "
          f"(rel {loss_rel:.3e}, bar 2e-2); gradient leaves: worst relative "
          f"L2 error {l2[worst]:.3e} (leaf {worst} of {len(l2)}, bar "
          f"{GRAD_BAR}), median {sorted(l2)[len(l2) // 2]:.3e}, worst "
          f"relative max error {max(rel_err(a, b) for a, b in zip(gk, gp)):.3e} "
          f"[{card}]", flush=True)
    if loss_rel > 2e-2 or l2[worst] > GRAD_BAR:
        fail(f"a {cfg.name} training step through the kernels differs from "
             f"the plain twins: loss {loss_rel}, gradient leaf {worst} "
             f"{l2[worst]}")
    del params, leaves, gk, gp, got
    torch.cuda.empty_cache()


def reduced_dense(card, configs, lm, train, counters) -> None:
    """Phase 4 for C1: each reduced dense config (head dims 16 and 32) at
    2 x 2048 tokens through the kernels: the forward against the plain
    twins (relative max <= 2e-2) with one flash launch per layer, and one
    train step with two flash forwards and one backward per layer and a
    finite loss."""
    for arch in DENSE:
        cfg = configs.get(arch, reduced=True)
        model, state, step, _ = train.build_trainer(cfg, device="cuda")
        batch = train_batches(cfg, 1)[0]
        batch = {k: t[:2] for k, t in batch.items()}
        set_counts(counters)
        with torch.no_grad():
            logits = model.forward(state.params, batch["tokens"])
            fwd = read_counts(counters)
            want = lm.build(cfg, force="plain").forward(state.params,
                                                        batch["tokens"])
        rel = rel_err(logits, want)
        set_counts(counters)
        state, m = step(state, batch)
        loss = float(m["loss"])
        trained = read_counts(counters)
        n = cfg.n_layers
        print(f"reduced {cfg.name} (hd {cfg.head_dim}) at 2 x {PROMPT}: "
              f"forward kernels vs plain rel max err {rel:.3e}, launches "
              f"{fwd}; train step loss {loss:.4f}, launches {trained} [{card}]",
              flush=True)
        if (rel > 2e-2 or not math.isfinite(loss)
                or fwd != {"flash_attention": n, "flash_attention_bwd": 0,
                           "wkv6": 0}
                or trained != {"flash_attention": 2 * n,
                               "flash_attention_bwd": n, "wkv6": 0}):
            fail(f"reduced {cfg.name} through the kernels: rel {rel}, loss "
                 f"{loss}, launches {fwd} / {trained}")
        del model, state, step, logits, want


def serve_numbers(card, cfg, lm, fa) -> None:
    """Phases 4b and 5 for a dense model at full width: prefill logits
    through the kernel against the plain twin (relative max <= 2e-2),
    prefill ms through each, decode ms / token, and the profiler's
    device-busy share of one prefill (with the flash forward's share) and
    of a decode step."""
    model = lm.build(cfg)
    plain = lm.build(cfg, force="plain")
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
            fail(f"{cfg.name} prefill did not launch the kernel once per "
                 "layer")
        want = plain.prefill(params, prompts,
                             plain.init_cache(BATCH, PROMPT + GEN, dev))
        rel = rel_err(got, want)
        print(f"{cfg.name} prefill logits kernel vs plain: rel max err "
              f"{rel:.3e}", flush=True)
        if not (torch.isfinite(got).all().item() and rel <= 2e-2):
            fail(f"{cfg.name} prefill logits through the kernel differ from "
                 f"plain: {rel}")

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
        print(f"{cfg.name} prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms "
              f"through the kernel, {plain_prefill_ms:.3f} ms through the "
              f"plain twin; decode {decode_ms:.3f} ms/token, "
              f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH} "
              f"[{card}]", flush=True)

        # 5. where the time goes: profiled device time against the above
        rows = device_kernels(lambda: model.prefill(params, prompts, cache))
        report_busy(f"{cfg.name} prefill", rows, prefill_ms, 1)
        flash = [e for e in rows if "flash_fwd" in e.key]
        if flash:
            flash_ms = sum(e.self_device_time_total for e in flash) / 1e3
            print(f"{cfg.name} prefill: the flash forward {flash_ms:.3f} ms "
                  f"of device time x{sum(e.count for e in flash)}, "
                  f"{100 * flash_ms / prefill_ms:.1f} % of the "
                  f"{prefill_ms:.3f} ms prefill [{card}]", flush=True)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + i)
        report_busy(f"{cfg.name} decode step", device_kernels(three_steps),
                    decode_ms, 3)
    del params, cache, got, want


def dense_serve(card, configs, serve, counters, arch) -> int:
    """Phase 3 for a dense model: `serve.main` at full width with every
    count set to 0 just before and read just after (one flash forward per
    layer, nothing else; tokens in range).  Returns the serve's flash
    launches."""
    cfg = configs.get(arch)
    toks, counts, serve_s = serve_counted(serve, arch, counters)
    print(f"serve {arch}: {serve_s:.3f}s end to end (weights init included), "
          f"launches {counts} [{card}]", flush=True)
    if counts != {"flash_attention": cfg.n_layers, "flash_attention_bwd": 0,
                  "wkv6": 0}:
        fail(f"serve {arch} launched {counts}; want flash_attention once "
             f"per layer ({cfg.n_layers}) and nothing else")
    check_tokens(toks, cfg.vocab, arch)
    del toks
    return counts["flash_attention"]


def misaligned(t, pad):
    """`t` (B,S,H,hd) copied into a view of a wider buffer whose base sits
    one element in and whose token stride is H*hd + pad elements."""
    b, s, h, hd = t.shape
    ts = h * hd + pad
    view = torch.zeros(1 + b * s * ts, device=t.device).as_strided(
        t.shape, (s * ts, ts, hd, 1), 1)
    return view.copy_(t)


def wkv_inputs(case, seed=0):
    """r, k, v ~ 0.5 N; w = exp(-exp(decay + 0.5 N)); u ~ 0.1 N;
    s0 ~ 0.1 N or None; float32 on the card, r, k, v, w `misaligned`
    where the case has a pad."""
    b, s, h, hd, _, decay, with_s0, pad = case
    g = torch.Generator("cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (0.5 * n(b, s, h, hd) for _ in "rkv")
    w = torch.exp(-torch.exp(decay + 0.5 * n(b, s, h, hd)))
    if pad:
        r, k, v, w = (misaligned(t, pad) for t in (r, k, v, w))
    u = 0.1 * n(h, hd)
    return r, k, v, w, u, 0.1 * n(b, h, hd, hd) if with_s0 else None


WKV_BAR = "elementwise |got - want| <= 1e-4 + 1e-4 |want|"


def wkv_ok(got, want) -> tuple[bool, float]:
    """Whether a WKV6 result is finite and meets WKV_BAR (the bar of
    tests/test_kernels.py), and its max abs error."""
    d = (got - want).abs()
    return (bool(torch.isfinite(got).all().item()
                 and (d <= 1e-4 + 1e-4 * want.abs()).all().item()),
            d.max().item())


def wkv_bound(case) -> tuple[float, str]:
    """Least time (ms): r, k, v, w, u and s0 read once, y and s_final
    written once, against the recurrence's 4*B*S*H*hd^2 fp32 operations."""
    b, s, h, hd, _, _, with_s0, _ = case
    nbytes = 4 * (5 * b * s * h * hd + h * hd
                  + (2 if with_s0 else 1) * b * h * hd * hd)
    flops = 4.0 * b * s * h * hd * hd
    return roofline(flops, nbytes, PEAK_F32_FLOPS)


def check_wkv6(wkv) -> float:
    """Phase 2 for wkv6; returns the max abs error of y at the main path's
    shape."""
    main_err = None
    for case in WKV_CASES:
        r, k, v, w, u, s0 = wkv_inputs(case)
        if case[-1] and wkv.copy_bytes(r, k, v, w) != 4:
            fail(f"wkv6 {case} would not take the 4-byte copy path")
        y, s = wkv.wkv6(r, k, v, w, u, s0, chunk=case[4])
        want_y, want_s = wkv.wkv6_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        ok_y, err_y = wkv_ok(y, want_y)
        ok_s, err_s = wkv_ok(s, want_s)
        print(json.dumps({"wkv6_case": list(case), "max_abs_err_y": err_y,
                          "max_abs_err_state": err_s, "bar": WKV_BAR,
                          "ok": ok_y and ok_s}), flush=True)
        if not (ok_y and ok_s):
            fail(f"wkv6 {case}: error y {err_y}, state {err_s}")
        if case is WKV_MAIN:
            main_err = err_y
        del r, k, v, w, u, s0, y, s, want_y, want_s
    # state carry: two halves with the carried state against one run
    case = (2, 600, 40, 64, 32, -3.0, False, 0)
    r, k, v, w, u, _ = wkv_inputs(case, seed=1)
    y_all, s_all = wkv.wkv6(r, k, v, w, u)
    y1, s1 = wkv.wkv6(r[:, :333], k[:, :333], v[:, :333], w[:, :333], u)
    y2, s2 = wkv.wkv6(r[:, 333:], k[:, 333:], v[:, 333:], w[:, 333:], u, s1)
    torch.cuda.synchronize()
    ok_y, err_y = wkv_ok(torch.cat([y1, y2], 1), y_all)
    ok_s, err_s = wkv_ok(s2, s_all)
    print(json.dumps({"wkv6_state_carry": list(case), "max_abs_err_y": err_y,
                      "max_abs_err_state": err_s, "bar": WKV_BAR,
                      "ok": ok_y and ok_s}), flush=True)
    if not (ok_y and ok_s):
        fail(f"wkv6 state carry: error y {err_y}, state {err_s}")
    return main_err


def serve_counted(serve, arch, counters) -> tuple:
    """Phase 3 for one model: every launch counter set to 0 just before
    `serve.main`, read just after.  Returns (tokens, {kernel: launches},
    seconds)."""
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks = serve.main(["--arch", arch, "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return toks, {name: fn.launches for name, fn in counters.items()}, dt


def check_tokens(toks, vocab: int, arch: str) -> None:
    if toks.shape != (BATCH, GEN) or not (0 <= int(toks.min())
                                          and int(toks.max()) < vocab):
        fail(f"serve {arch} tokens {tuple(toks.shape)} out of range")


def wkv6_f64(r, k, v, w, u, s0=None):
    """The WKV6 recurrence in float64, rounded to float32 at the end: the
    exact answer that both the kernel and the plain twin approximate."""
    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.double() for t in (r, k, v, w))
    uf = u.double()[None, :, :, None]
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float64, device=r.device)
          if s0 is None else s0.double())
    y = torch.empty((b, s, h, hd), dtype=torch.float64, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv)
        st = wf[:, t, :, :, None] * st + kv
    return y.float(), st.float()


def check_rwkv_prefill(cfg, lm, wkv, plain, params, prompts, got, want):
    """Phase 4 for RWKV6-3B, prefill through the kernel against the plain
    twin.  Layer by layer on the same inputs (the kernel's own effect):
    relative max error <= 2e-2 for every block.  End to end over 32 layers
    the bf16 rounding differences that any two fp32 summation orders leave
    grow with depth, so the logits are held to max(2e-2, 1.5 x the plain
    twin's own distance from the float64 recurrence)."""
    from repro_torch.models import layers
    seg = lm.layer_plan(cfg)[0]
    dev = prompts.device
    x = layers.embed(params["embed"], prompts)
    pos = torch.arange(PROMPT, device=dev)[None]
    worst = 0.0
    for lp in params["seg0"]:
        outs = [lm._apply_block(
            lp, cfg, seg, x, pos, force=force,
            cache=lm._init_block_cache(cfg, seg, BATCH, 0, dev))
            for force in (None, "plain")]
        worst = max(worst, rel_err(*outs))
        x = outs[0]
    plain_fn, wkv.wkv6_plain = wkv.wkv6_plain, wkv6_f64
    try:
        exact = plain.prefill(params, prompts,
                              plain.init_cache(BATCH, PROMPT, dev))
    finally:
        wkv.wkv6_plain = plain_fn
    rel, floor = rel_err(got, want), rel_err(want, exact)
    bar = max(2e-2, 1.5 * floor)
    print(f"rwkv prefill: worst block kernel vs plain on the same input "
          f"{worst:.3e} (bar 2e-2); logits kernel vs plain {rel:.3e} (bar "
          f"{bar:.3e}); plain vs float64 recurrence {floor:.3e}; kernel vs "
          f"float64 {rel_err(got, exact):.3e}", flush=True)
    if worst > 2e-2:
        fail(f"an rwkv block through the kernel differs from plain: {worst}")
    if not (torch.isfinite(got).all().item() and rel <= bar):
        fail(f"rwkv prefill logits through the kernel differ: {rel}")


def rwkv_path(card, configs, lm, serve, wkv, counters) -> dict:
    """Phases 3-5 for RWKV6-3B; returns the wkv6 entry of the kernels
    line."""
    cfg = configs.get(RWKV_ARCH)
    toks, launches, serve_s = serve_counted(serve, RWKV_ARCH, counters)
    print(f"serve {RWKV_ARCH}: {serve_s:.3f}s end to end (weights init "
          f"included), launches {launches} [{card}]", flush=True)
    want = {"wkv6": cfg.n_layers * GEN, "flash_attention": 0,
            "flash_attention_bwd": 0}
    if launches != want:
        fail(f"serve {RWKV_ARCH} launched {launches}; want {want} (one "
             "wkv6 per layer for the prefill and each of the "
             f"{GEN - 1} decode steps)")
    check_tokens(toks, cfg.vocab, RWKV_ARCH)
    del toks

    # 4a. kernel timings at the main path's shape
    args = wkv_inputs(WKV_MAIN)
    ms = time_ms(lambda: wkv.wkv6(*args, chunk=WKV_MAIN[4]), 20)
    plain_ms = time_ms(lambda: wkv.wkv6_plain(*args), 2, warmup=1)
    bound_ms, bound_by = wkv_bound(WKV_MAIN)
    print(f"wkv6 {WKV_MAIN[:4]} fp32 with s0: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]", flush=True)
    # the decode step's call: one launch is shorter than the host's work
    # around it, so its device time comes from the profiler
    args = wkv_inputs(WKV_DECODE)
    call_ms = time_ms(lambda: wkv.wkv6(*args, chunk=WKV_DECODE[4]), 200)
    dev_ms = kernel_device_ms(
        lambda: wkv.wkv6(*args, chunk=WKV_DECODE[4]), "wkv6_kernel")
    dec_plain_ms = time_ms(lambda: wkv.wkv6_plain(*args), 20)
    dec_bound_ms, dec_bound_by = wkv_bound(WKV_DECODE)
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"wkv6 {WKV_DECODE[:4]} fp32 with s0 (decode step): kernel {dev} "
          f"device time per launch (profiler), {call_ms:.4f} ms per call "
          f"with the host's work; plain {dec_plain_ms:.4f} ms per call, "
          f"bound {dec_bound_ms:.4f} ms ({dec_bound_by}) [{card}]",
          flush=True)
    del args

    # 4b. prefill through the kernel vs the plain twin; decode timing
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    dev = torch.device("cuda")
    params = model.init(torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    with torch.inference_mode():
        cache = model.init_cache(BATCH, PROMPT + GEN, dev)
        before = wkv.wkv6.launches
        got = model.prefill(params, prompts, cache)
        torch.cuda.synchronize()
        if wkv.wkv6.launches - before != cfg.n_layers:
            fail("rwkv prefill did not launch wkv6 once per layer")
        t0 = time.perf_counter()
        want_logits = plain.prefill(params, prompts,
                                    plain.init_cache(BATCH, PROMPT + GEN, dev))
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
        check_rwkv_prefill(cfg, lm, wkv, plain, params, prompts, got,
                           want_logits)

        prefill_ms = time_ms(lambda: model.prefill(params, prompts, cache),
                             3, warmup=1)
        cache = model.init_cache(BATCH, PROMPT + GEN, dev)
        tok = model.prefill(params, prompts, cache)[:, -1].argmax(
            dim=-1, keepdim=True)
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
        print(f"rwkv prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms through "
              f"the kernel, {plain_prefill_ms:.3f} ms through the plain twin "
              f"(one call, host clock); decode {decode_ms:.3f} ms/token, "
              f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH} "
              f"[{card}]", flush=True)

        # 5. where the time goes
        report_busy("rwkv prefill", device_kernels(
            lambda: model.prefill(params, prompts, cache)), prefill_ms, 1)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + GEN + i)
        report_busy("rwkv decode step", device_kernels(three_steps),
                    decode_ms, 3)
    del params, cache, got, want_logits

    # 4c. the reduced model on the GPU (kernel at hd 16) against the CPU
    small = configs.get(RWKV_ARCH, reduced=True)
    sm = lm.build(small)
    sp = sm.init(torch.Generator("cpu").manual_seed(0))
    stoks = torch.randint(0, small.vocab, (2, 64),
                          generator=torch.Generator("cpu").manual_seed(2))
    cpu_logits = sm.forward(sp, stoks)
    before = wkv.wkv6.launches
    gpu_logits = sm.forward(tree_map(lambda t: t.to(dev), sp),
                            stoks.to(dev)).cpu()
    rel_small = rel_err(gpu_logits, cpu_logits)
    print(f"reduced {small.name} forward, GPU vs CPU: rel max err "
          f"{rel_small:.3e} ({wkv.wkv6.launches - before} wkv6 launches)",
          flush=True)
    if rel_small > 2e-2 or wkv.wkv6.launches - before != small.n_layers:
        fail(f"reduced rwkv forward on the GPU differs from the CPU: "
             f"{rel_small}")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:78",
            "launches": launches["wkv6"], "max_abs_err": None, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def nested_rel(got, want, where: str = "") -> float:
    """Largest relative difference over the floats of nested dicts / lists;
    fails on any other value that differs (labels, orgs, capacities)."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            fail(f"{where}: keys {sorted(got)} != {sorted(want)}")
        return max((nested_rel(got[k], want[k], f"{where}/{k}")
                    for k in want), default=0.0)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{where}: {len(got)} entries != {len(want)}")
        return max((nested_rel(g, w, f"{where}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))), default=0.0)
    if isinstance(want, float):
        return abs(got - want) / max(abs(want), 1e-300)
    if got != want:
        fail(f"{where}: {got!r} != {want!r}")
    return 0.0


def held(label: str, err: float, bar: float = PIPELINE_REL) -> float:
    print(f"  {label}: max rel err {err:.3e} (bar {bar:g})", flush=True)
    if not err <= bar:
        fail(f"{label}: {err} > {bar}")
    return err


def pipeline_phase(card) -> dict:
    """Phase 6: the float64 DeepNVM++ pipeline (`repro_torch.core`) on the
    card: the Table II anchors against the scalar path, the paper's
    analyses against the JAX reference's numbers, and the full mega sweep
    cold, warm and sharded, against itself and against the port's CPU run
    on this machine.  Returns the `{"pipeline": ...}` record."""
    from repro_torch import scenarios
    from repro_torch.core import (cachemodel, engine, isoarea, isocap,
                                  scaling, sweep, tuner, workload_engine)
    from repro_torch.core.calibration import TABLE2
    dev, mems, cap = "cuda", ("sram", "stt", "sot"), 3 * 2**20
    fields = ("read_latency_s", "write_latency_s", "read_energy_j",
              "write_energy_j", "leakage_w", "area_mm2")
    t_phase = time.perf_counter()
    print(f"pipeline: {card}", flush=True)

    # paper anchors: Table II at 3 MB through the engine on the card,
    # against the scalar path (evaluate_scalar, tune_loop) and Table II
    table = engine.design_table(mems, (cap,), device=dev)
    scalar_err = 0.0
    for mem in mems:
        d = table.tuned(mem, cap)
        model = cachemodel.CacheModel(mem, device=dev)
        loop = tuner.tune_loop(model, cap)
        if d.org != loop.org:
            fail(f"{mem}: tuned org {d.org} != tune_loop's {loop.org}")
        one = model.evaluate_scalar(cap, d.org)
        for f in fields:
            for other in (loop, one):
                scalar_err = max(scalar_err, abs(getattr(d, f)
                                                 - getattr(other, f))
                                 / abs(getattr(other, f)))
    held("Table II designs at 3 MB (cuda) vs evaluate_scalar / tune_loop",
         scalar_err)
    t2 = tuner.table2(device=dev)
    held("Table II columns vs the JAX reference", nested_rel(
        {col: {"capacity_bytes": d.capacity_bytes, "org": str(d.org),
               **{f: getattr(d, f) for f in fields}}
         for col, d in t2.items()}, PIPELINE_GOLDEN["table2"], "table2"))
    anchor_err = max(
        abs(m - r) / r for col in mems for m, r in (
            (t2[col].capacity_mb, TABLE2[col]["cap"]),
            (t2[col].read_latency_s * 1e9, TABLE2[col]["rlat"]),
            (t2[col].write_latency_s * 1e9, TABLE2[col]["wlat"]),
            (t2[col].read_energy_j * 1e9, TABLE2[col]["re"]),
            (t2[col].write_energy_j * 1e9, TABLE2[col]["we"]),
            (t2[col].leakage_w * 1e3, TABLE2[col]["leak"]),
            (t2[col].area_mm2, TABLE2[col]["area"])))
    print(f"  Table II 3 MB anchor error {anchor_err:.6e} (the reference's "
          f"{PIPELINE_GOLDEN['table2_anchor_max_rel_err']:.6e})")
    held("Table II 3 MB anchor error vs the reference's",
         abs(anchor_err - PIPELINE_GOLDEN["table2_anchor_max_rel_err"])
         / PIPELINE_GOLDEN["table2_anchor_max_rel_err"], ANCHOR_ERR_REL)

    # the paper's analyses on the card against the reference's numbers
    caps = {m: tuner.iso_area_capacity(m, device=dev) for m in ("stt", "sot")}
    nested_rel(caps, PIPELINE_GOLDEN["isoarea_capacities_mb"], "iso-area")
    print(f"  iso-area capacities at the 3 MB SRAM area: {caps} MB")
    analyses = {
        "isocap_summary": isocap.summary(isocap.analyze(device=dev)),
        "isoarea_summary": isoarea.summary(isoarea.analyze(device=dev)),
        "scaling_headline": scaling.headline(
            scaling.workload_sweep(device=dev))}
    analyses_err = max(held(f"{k} (cuda) vs the JAX reference",
                            nested_rel(v, PIPELINE_GOLDEN[k], k))
                       for k, v in analyses.items())

    # the mega sweep: 182 scenarios x 288 designs x 2 platforms
    spec = scenarios.mega_spec()
    cells = sweep.n_cells(spec)
    widest = max(len(s.streams) for s in spec.scenarios)
    print(f"  mega spec: {len(spec.scenarios)} scenarios x "
          f"{len(spec.designs)} designs x {len(spec.platforms)} platforms = "
          f"{cells} cells, up to {widest} streams", flush=True)

    def forget():
        """Drop the sweep's, the fold's and the circuit tables' memos (the
        calibration and the scenarios' traffic stay memoized)."""
        sweep.clear_cache()
        workload_engine.evaluate_platforms.cache_clear()
        engine.design_table.cache_clear()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()

    # cold: the spec's first run in the process (the calibration is fitted
    # and the CUDA context up already); every later run starts after
    # forget(), so each rebuilds the circuit table, tunes and folds
    runs = {}
    cold, runs["cold"], peak_cold = timed(lambda: sweep.run(spec, device=dev))
    warm_runs = []
    for _ in range(3):
        forget()
        warm, sec, peak_warm = timed(lambda: sweep.run(spec, device=dev))
        warm_runs.append(sec)
    runs["warm"] = sorted(warm_runs)[1]
    print(f"  mega warm runs: {warm_runs} s", flush=True)
    # the warm run's two halves: the circuit table with Algorithm 1 for
    # every design, and the fold (pack, the device, the copy back)
    forget()
    (_, designs), lower_s, _ = timed(
        lambda: sweep.lower_designs(spec.designs, device=dev))
    _, fold_s, _ = timed(lambda: workload_engine.evaluate_platforms(
        spec.scenarios, designs, spec.platforms, device=dev))
    print(f"  warm halves: lower_designs {lower_s:.4f} s, fold "
          f"{fold_s:.4f} s", flush=True)
    forget()
    # device-busy share of the warm run: profiled device time over the
    # unprofiled run's wall time
    rows = device_kernels(lambda: sweep.run(spec, device=dev))
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 \
        if rows else None
    busy = busy_ms / (1e3 * runs["warm"]) if rows else None
    print(f"  warm run: device busy {busy_ms} ms of {1e3 * runs['warm']:.3f}"
          f" ms ({busy})" if rows else "  warm run: device time not "
          "measured (no CUDA profiler events)", flush=True)
    sharded = {}
    for devices in (None, 1):
        forget()
        plan = sweep.ShardPlan(**MEGA_PLAN, devices=devices)
        sharded[devices], runs[f"sharded_devices_{devices}"], _ = timed(
            lambda: sweep.run(spec, plan, device=dev))
    t = time.perf_counter()
    on_cpu = sweep.run(spec, device="cpu")
    runs["cpu"] = time.perf_counter() - t

    want = warm.rows()
    orgs = [str(d.org) for d in warm.designs]
    errs = {}
    for label, res in (("cold", cold), ("sharded_devices_None",
                                        sharded[None]),
                       ("sharded_devices_1", sharded[1]), ("cpu", on_cpu)):
        if [str(d.org) for d in res.designs] != orgs:
            fail(f"mega {label}: tuned organizations differ from the warm "
                 "run's")
        errs[label] = held(f"mega rows, {label} vs warm (cuda)",
                           nested_rel(res.rows(), want, f"mega/{label}"))
    for label, sec in runs.items():
        print(f"  mega {label}: {sec:.3f} s, {cells / sec:,.0f} cells/s",
              flush=True)
    print(f"  peak allocated: cold {peak_cold / 2**20:.1f} MiB, warm "
          f"{peak_warm / 2**20:.1f} MiB", flush=True)
    record = {
        "card": card, "cells": cells, "scenarios": len(spec.scenarios),
        "designs": len(spec.designs), "platforms": len(spec.platforms),
        "max_streams": widest, "seconds": runs,
        "cells_per_s": {k: cells / v for k, v in runs.items()},
        "warm_runs_s": warm_runs,
        "warm_halves_s": {"lower_designs": lower_s, "fold": fold_s},
        "max_memory_allocated": {"cold": peak_cold, "warm": peak_warm},
        "warm_device_busy_ms": busy_ms,
        "warm_device_busy_share": busy,
        "max_rel_err": {"table2_vs_scalar": scalar_err,
                        "analyses_vs_reference": analyses_err,
                        **{f"mega_{k}_vs_warm": v for k, v in errs.items()}},
        "table2_anchor_max_rel_err": anchor_err,
        "isoarea_capacities_mb": caps,
        "phase_s": time.perf_counter() - t_phase}
    print(f"pipeline phase: {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as configs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch import serve, train
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
        log = build.log(name)
        for line in log.splitlines():
            if "arning" in line or "(C75" in line:
                print(f"  {name}: {line.strip()}")
        for row in ptxas_report(log):
            print(f"  {name}: {row['kernel']}: {row['registers']} registers,"
                  f" {row['spill']} bytes spill stores", flush=True)
            # the tensor-core kernels: no spills, no serialized wgmma
            if "_bf16<" in row["kernel"] and (row["spill"] or row["c75"]):
                fail(f"{row['kernel']}: {row['spill']} bytes spilled, "
                     f"{row['c75']}")

    # 2. kernels against their plain twins
    errs = check_kernels(fa, ref)
    wkv_main_err = check_wkv6(wkv)

    # 3-5 for the dense main paths, TinyLlama-1.1B and Gemma-7B (hd 256)
    counters = {"flash_attention": fa.flash_attention,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "wkv6": wkv.wkv6}
    launches = dense_serve(card, configs, serve, counters, ARCH)

    # 4a. kernel timings at the main path's shape, at hd 128 and hd 256
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_flash(fa, MAIN, card)
    time_flash(fa, HD128, card)
    time_flash(fa, GEMMA_B2, card)
    bwd = time_flash_bwd(fa, ref, MAIN, card)
    time_flash_bwd(fa, ref, HD128, card)
    bwd_parts(fa, MAIN, card)

    # 4b and 5 for TinyLlama-1.1B
    serve_numbers(card, configs.get(ARCH), lm, fa)

    # 4c. the reduced model on the GPU against the CPU (non-kernel layers)
    dev = torch.device("cuda")
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
    del sp, sp_gpu, cpu_logits, gpu_logits
    torch.cuda.empty_cache()

    # 3-4 for the training main path, and C1's reduced configs
    trained = train_path(card, configs.get(ARCH), BATCH, train, counters)
    train_vs_plain(card, configs.get(ARCH), BATCH, lm)
    reduced_dense(card, configs, lm, train, counters)

    # 3-5 for the RWKV main path
    wkv_entry = rwkv_path(card, configs, lm, serve, wkv, counters)
    wkv_entry["max_abs_err"] = wkv_main_err

    # 3-5 for Gemma-7B (hd 256), last: the phases above run as they ran
    # before it was added, so their host-bound times stay comparable, and
    # its 17 GB of params never share the card with training's state.  4a
    # times the forward at the shape its prefill gives the kernel, and the
    # backward at the shape its training gives the kernel.  Then Gemma-7B
    # trains at full width and GEMMA_TRAIN_LAYERS deep, through the hd-256
    # forward (with lse) and backward.
    gemma_launches = dense_serve(card, configs, serve, counters, GEMMA_ARCH)
    gemma_t = time_flash(fa, GEMMA, card)
    gemma_bwd = time_flash_bwd(fa, ref, GEMMA_B2, card)
    bwd_parts(fa, GEMMA_B2, card)
    serve_numbers(card, configs.get(GEMMA_ARCH), lm, fa)
    torch.cuda.empty_cache()
    gemma_cfg = dataclasses.replace(configs.get(GEMMA_ARCH),
                                    n_layers=GEMMA_TRAIN_LAYERS)
    print(f"train {GEMMA_ARCH}: every published width, depth cut to "
          f"{GEMMA_TRAIN_LAYERS} of {configs.get(GEMMA_ARCH).n_layers} "
          "layers (fp32 masters and AdamW for all of them need ~136 GB)",
          flush=True)
    gemma_trained = train_path(card, gemma_cfg, GEMMA_TRAIN_BATCH, train,
                               counters)
    train_vs_plain(card, gemma_cfg, GEMMA_TRAIN_BATCH, lm)

    # 6. the float64 DeepNVM++ pipeline, on a card with Gemma's memory
    # released
    torch.cuda.empty_cache()
    pipeline = pipeline_phase(card)

    fwd_src = {"route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:78"}
    # no TPU kernel: the backward replaces the jnp VJP of flash_attention_ref
    bwd_src = {"route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "replaces": "src/repro/kernels/ref.py:106"}
    print(json.dumps({"kernels": [{
        "name": "flash_attention", **fwd_src,
        "launches": launches, "max_abs_err": errs[MAIN][0], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}, {
        # the same wrapper and source at head dim 256: Gemma-7B's serve
        "name": "flash_attention_hd256", **fwd_src,
        "launches": gemma_launches, "max_abs_err": errs[GEMMA][0],
        "ms": gemma_t[0], "plain_ms": gemma_t[1], "bound_ms": gemma_t[3],
        "bound_by": gemma_t[4], "library_ms": gemma_t[2]}, {
        "name": "flash_attention_bwd", **bwd_src,
        "launches": trained["launches"]["flash_attention_bwd"],
        "max_abs_err": errs[MAIN][1], "ms": bwd[0], "plain_ms": bwd[1],
        "bound_ms": bwd[3], "bound_by": bwd[4], "library_ms": bwd[2]}, {
        # the same wrapper and source at head dim 256: Gemma-7B's training
        "name": "flash_attention_bwd_hd256", **bwd_src,
        "launches": gemma_trained["launches"]["flash_attention_bwd"],
        "max_abs_err": errs[GEMMA_B2][1], "ms": gemma_bwd[0],
        "plain_ms": gemma_bwd[1], "bound_ms": gemma_bwd[3],
        "bound_by": gemma_bwd[4], "library_ms": gemma_bwd[2]},
        wkv_entry]}))
    print(json.dumps({"pipeline": pipeline}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
