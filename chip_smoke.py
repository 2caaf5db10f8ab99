#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every CUDA kernel from
     `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel)
     and print ptxas's registers and spills per kernel and its warning and
     C75xx lines (fatal for a tensor-core kernel or an MLA-layout
     backward kernel that spills or has a C75xx line, and for the wkv6
     pair walk, a selective-scan kernel or an MLA-layout forward kernel
     that spills);
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
     256); the flash forward at DeepSeek-V3's MLA layout (q of head dim
     576, one shared k head of 576 and v head of 512) over MLA_CASES (1,
     3 and 128 heads; Sq / Skv 1, 63, 64, 65, 127, 129, 191, a decode step
     at position 2063 of a 2064-position cache, the 2048-token prefill
     into it and a 100-token prefill at position 1900 of it; v a view of
     k's first 512 features and a tensor of its own) in fp32 and bf16
     within the same bars, one launch of its own a call, the kernel that
     ran printed (every bf16 case the wgmma kernel, every fp32 case the
     SIMT kernel); the flash backward at the MLA layout over the same
     cases and MLA_BWD_EXTRA (20 heads: ragged head groups) in fp32 and
     bf16, dq, dk and dv against autograd of the plain twin within the
     backward's bars, and where v is a view of k the fused form (dq and
     k's whole gradient dk + [dv, 0], as `FlashAttention` asks for it)
     within the same bars, one launch of its own a call, the kernels that
     ran printed (`fa.mla_bwd_kernel`: every bf16 case the wgmma kernels,
     every fp32 case the SIMT kernels), two calls bitwise
     equal at V3's training shape (1, 2048, 128) and at a ragged fp32
     case, and `ops.attention` under grad at 2048 positions (v a view of
     k) giving an output whose backward launches it once, q's and k's
     gradients within the bf16 bar; wkv6 over WKV_CASES (one with rows that take the
     kernel's 4-byte copy path) and a state-carry case, y and the final
     state within |got - want| <= 1e-4 + 1e-4 |want| elementwise, the main
     shape included; the wkv6 backward over WKV_CASES with a random
     ds_final (and at the main shape without, as training calls it): dr,
     dk, dv, dw, du and ds0 against `ref.wkv6_bwd_plain` within 1e-4 x
     max(max |want|, 1) absolute, the forward's checkpoints against the
     plain recurrence's states and its y bitwise equal to serving's, the
     backward's reverse-pass checkpoints (the gradient after every span)
     against `ref.wkv6_grad_checkpoints`, and two backward calls at (4,
     2048, 40, 64) bitwise equal; the wkv6 backward's span walk must not
     spill (phase 1); the selective scan over SCAN_CASES (N 4 and 16; D
     64, 77, 1600; S 1 to 2048, at the kernels' chunk boundaries among
     them; with and without h0; strong decay): y,
     h_last and the checkpoints within 1e-5 (relative max) of the plain
     loop and `ref.ssm_checkpoints`, y and h_last with checkpoints
     bitwise equal to serving's, the backward's ddt, du, dB, dC, da and
     dh0 against `ref.ssm_scan_bwd_plain` within 1e-4 x max(max |want|,
     1), two backward calls at (4, 2048, 1600, 16) bitwise equal;
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
     kernels; after the RWKV6-3B serve, the same training phase on
     RWKV6-3B at every published width and full depth (batch 4 x 2048:
     exactly 64 wkv6 forwards, each writing checkpoints, and 32 wkv6
     backwards a step), its step through the kernels against the plain
     twins at RWKV_CHECK_LAYERS layers, and the backward timed at (4,
     2048, 40, 64) beside its plain twin and bound (by CUDA events, by
     the profiler per launch, summed and from the first launch's start to
     the last one's end, and the host time of one wrapper call), with the
     forward with and without checkpoints; last, after the Gemma-7B serve,
     the same
     training phase on
     Gemma-7B at full width (every published width; its one reduction is
     depth, 6 of 28 layers, GEMMA_TRAIN_LAYERS, as fp32 masters with
     AdamW for all 28 need ~136 GB) at batch 2 x seq 2048: exactly 12
     flash forwards and 6 flash backwards (head dim 256) a step;
  4. per model: prefill logits through the kernel against those through
     the plain twin (relative max error <= 2e-2, and each layer's
     attention on the same input; for RWKV6-3B each block on the same
     input, and the logits within max(2e-2, 1.5 x the plain twin's
     distance from a float64 recurrence); for DeepSeek-MoE, whose routing
     turns bf16 rounding into other experts, the logits within max(2e-2,
     1.5 x the plain twin's distance from the naive oracle), with the
     tokens whose experts differ counted), the same model at reduced
     width on the GPU against the CPU, and timings: kernel and plain twin
     (and for flash attention `scaled_dot_product_attention`, a yardstick
     the port never calls, and the achieved TFLOP/s) at the main path's
     shape, for flash attention also at Gemma-7B's hd 256 (2, 2048, 16,
     256) and, in the Gemma-7B phase, at the shape its prefill gives the
     kernel (4, 2048, 16, 256), for the flash backward beside SDPA's
     backward (in the Gemma-7B phase also at its training shape (2, 2048,
     16, 256)) with the
     profiler's device time of each of its three launches (at the main
     shape and at hd 256), for wkv6 also the decode step's
     call (4, 1, 40, 64) (device time from the profiler), prefill ms and
     decode ms per token;
  5. torch.profiler's device time for one prefill (with the flash
     forward's share), three decode steps and one training step of each
     trained model, as a share of the timings above, with the heaviest
     kernels (and the flash backward's and the wkv6 forward's and
     backward's shares of the step);
  5b. after Gemma-7B's training, the card's memory released before each
     model: one `blocks.moe` call at DeepSeek-MoE 16B's full width in fp32
     on the 4 x 2048 tokens of its prefill, on the card and on the CPU from
     the same numpy-seeded inputs (equal experts and kept (token, slot)
     pairs, some dropped, the output within MOE_BLOCK_REL relative max,
     the aux within MOE_AUX_ABS; timed in fp32 and bf16), the reduced
     DeepSeek-MoE on the GPU against the CPU, then DeepSeek-MoE 16B and
     Chameleon-34B served at every published width and full depth as in
     phases 3-5 (exactly 28 / 48 flash forwards a serve and nothing else;
     prefill logits within 2e-2 of the plain twin; prefill ms, decode
     ms/token, busy shares, the weights' bytes and peak memory), with the
     flash forward timed at their prefill shapes (4, 2048, 16 | 64, 128)
     beside SDPA, and one `build_trainer` step of the reduced DeepSeek-MoE
     on the card (a finite loss, its router bias unchanged); then
     DeepSeek-MoE 16B trained at every published width, its depth cut to
     MOE_TRAIN_LAYERS (`moe_train`: batch 4 x 2048, fp32 masters, remat
     full, exactly 8 flash forwards and 4 backwards a step, every router
     bias bitwise unchanged; step ms, tokens/s, peak memory, finite
     losses, the flash kernels' shares of the step), its step through the
     kernels against the plain twins at MOE_CHECK_LAYERS layers within
     bars set by a third step through the naive oracle (the loss within
     max(2e-2, 1.5 x the oracle's distance), each gradient leaf within
     max(GRAD_BAR, 1.5 x the oracle's distance on that leaf), the tokens
     whose experts differ counted by MoE layer); then DeepSeek-V3: the
     MLA-layout kernel at its prefill shape (4, 2048 into 2064, 128 heads,
     576 / 512) bf16 beside its plain twin, SDPA given k and v expanded to
     128 heads and its bound, and the fp32 SIMT kernel there, with both
     kernels' registers and spills (`time_flash_mla`), one fp32 MLA block at
     full width (1 x 2048, then a decode step) card against CPU within
     V3_MLA_REL with its cache entries, the reduced V3 on the GPU against
     the CPU, and V3 served at every published width, its depth cut to
     V3_SERVE_LAYERS (`v3_serve`: `serve.generate`, exactly 5 MLA-layout
     launches a serve and nothing else; each layer's MLA within 2e-2 of
     the plain twin; the logits within max(2e-2, 1.5 x the naive oracle's
     distance), the tokens whose experts differ counted, one sequence at a
     time; prefill ms, decode ms/token, the MLA kernel's share of a
     profiled prefill, the weights' bytes and peak memory); then the MLA
     backward alone in bf16 at V3's training shape (1, 2048, 128, 576 /
     512) and at batch 4 beside its plain twin, SDPA's backward given k
     and v expanded to 128 heads and its bound, with each of its four
     launches by profiler at batch 1 (`time_flash_mla_bwd`), and V3
     trained at every published width, cut to V3_TRAIN_LAYERS layers and
     V3_TRAIN_EXPERTS routed experts with its MTP head (`v3_train`: batch
     1 x 2048, fp32 masters, remat full, exactly 5 MLA-layout forwards and
     3 backwards a step and nothing else, every router bias bitwise
     unchanged; params, step ms, tokens/s, peak memory, the MLA kernels'
     shares of the step), its step through the kernels against the plain
     twins at the same cut held by the naive oracle, leaf by leaf;
  5c. after DeepSeek-V3, Hymba-1.5B: one `blocks.ssm` call at its full
     width (d_inner 1600, state 16) in fp32 on the 4 x 2048 tokens of its
     prefill, card (the scan kernel) against CPU (the loop) from the same
     numpy-seeded inputs (output within SSM_BLOCK_REL, the bf16 state
     within one bf16 ulp plus that, and one decode step likewise; timed
     in fp32 and bf16, its launches counted),
     the reduced Hymba on the GPU against the CPU, the flash forward at its
     windowed (1024) and global prefill shapes at 25 heads beside SDPA
     (given the window as a boolean mask), then Hymba-1.5B served at every
     published width and full depth as in phases 3-5 (exactly 32 flash
     forwards a serve, 29 of them windowed, and 512 scan forwards, one a
     layer for the prefill and for each of the 15 decode steps; each
     layer's attention within 2e-2 of the plain twin, the prefill logits
     as `hybrid_logits_bar` holds them; the scan's and the flash
     forward's shares of the profiled prefill), all printed with 5b's as
     a `{"served": ...}` line; then Hymba-1.5B trained at every published
     width and full depth (`hymba_train`: batch 4 x 2048, fp32 masters,
     remat full, exactly 64 flash forwards, 32 flash backwards, 64 scan
     forwards with checkpoints and 32 scan backwards a step; step ms,
     tokens/s, peak memory, finite losses, the flash backward's and the
     scan kernels' shares of the step), its step through the kernels
     against the plain twins at HYMBA_CHECK_LAYERS layers (the dense
     bars; both steps' distances from a step in fp32 activations
     printed beside them), the flash backward at (4, 2048, 25, 64) with
     the 1024-key window beside SDPA's backward given the boolean mask,
     and the scan kernels timed at (4, 2048, 1600, 16) beside the loop and
     its backward's plain twin, with their bounds, each call's launches
     by profiler device time;
  5d. after it, Whisper-small (the encoder-decoder: 12 encoder + 12
     decoder layers, d_model 768, 12 heads x 64, 1500 frames) at every
     published width and full depth, with seeded bf16 frames: the flash
     forward and backward at its decoder's shape (4, 2048, 12, 64) beside
     SDPA, the plain twin and the bound (the shape also among CASES), the
     reduced model on the GPU against the CPU, `serve.main` at prompt 2048
     (exactly 12 flash forwards, one a decoder layer; the encoder's 1500
     frames, the cross-attention and decode launch none) and at the
     published 448-token decoder context (none at all), `serve.generate`
     counted likewise, the encoder's output in fp32 card against CPU
     (WHISPER_ENC_REL), the prefill logits given it and each decoder
     layer's self-attention within 2e-2 of the plain twin, encode /
     prefill / decode timings with busy shares and peak memory
     (`whisper_serve`); then its training at batch 4 x
     2048 (`whisper_train`: exactly 24 flash forwards and 12 backwards a
     step), its step through the kernels against the plain twins with the
     dense bars, every leaf (the encoder's and the cross-attention's
     among them) held and the five nearest their bars printed;
  5e. after it, Qwen3-14B and MiniCPM-2B (`qwen3_minicpm_phase`): the
     flash forward and backward in bf16 at their prefill and training
     shapes (4, 2048, 40, 128) and (4, 2048, 36, 64) against the plain
     twins (phase 2's bars) and timed beside SDPA, the plain twins and
     the bounds, the backward's three launches by profiler; AdamW's
     multi-tensor kernels at MiniCPM-2B's 362 leaves (`adamw_phase`: one
     step against the plain loop within 1e-6, the norm against float64;
     the update with its clip norm, the norm alone, the plain loop and
     clip_grad_norm_ + AdamW(fused=True) timed beside the bytes bound);
     both served
     at every published width and full depth as in 5b (exactly 40 flash
     forwards a serve; each layer's attention and the prefill logits
     within 2e-2 of the plain twins; prefill ms, decode ms/token, peak
     memory); MiniCPM-2B trained at full depth (batch 4 x 2048) and
     Qwen3-14B at every published width cut to QWEN3_TRAIN_LAYERS (batch
     2 x 2048), each step exactly 2n flash forwards and n backwards (and,
     in every training phase, AdamW's planned launches over every leaf), the
     LR AdamW took from `schedule_for` recorded and printed (WSD for
     MiniCPM-2B, cosine for Qwen3-14B), the step through the kernels
     against the plain twins with the dense bars (MiniCPM-2B's tied table
     one leaf, its distance printed);
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
     line;
  7. after it, the sweep service and its CLI (`repro_torch.sweep`) on
     `cuda`, at the traffic of benchmarks/bench_serve.py (the goldens
     isocap, dtco, dtco_isoarea and lm_nvm, SERVICE_COPIES clients each:
     32 concurrent requests, 3,696 cells a round) and the full mega spec
     as one request: `dtco.analyze` / `isoarea_analyze` on the card, their
     headlines against the reference's numbers (PIPELINE_GOLDEN) and
     their rows against the CPU's (1e-12); `python -m repro_torch.sweep
     run specs/dtco.json --csv` as a subprocess, its rows against
     `sweep.run` on the CPU (1e-12, equal labels) with the tuned orgs of
     the card's run equal to the CPU's; `python -m repro_torch.sweep
     serve --http 127.0.0.1:0 --warmup-spec specs/isocap.json
     --stats-on-exit` as a subprocess, driven through
     `repro_torch.sweep.client`: a cold first request (lm_nvm) and a
     warm one (isocap), the 32-request burst for summaries and again for
     rows (all cache hits), every response against `sweep.run` on the CPU
     (1e-12), the mega spec as one `shard` request (ShardPlan(64, 288),
     104,832 cells) against the pipeline phase's CPU summary, and SIGTERM
     with a request in flight (exit 0, the response delivered, the stats
     document read from stderr); then, in process, the burst one request
     at a time (`coalesce=False`) against the coalesced burst, and the
     profiler's device-busy share of one coalesced burst, printed as a
     `{"service": ...}` line;
  8. after it, the inverse designer (`repro_torch.inverse`) on `cuda`:
     the hardened centres recover the grid winner of isocap and
     dtco_isoarea as iso-area EDP problems (the same corner, values within
     1e-12), the grid against the reference's (INVERSE_GOLDEN, pinned by
     tests/test_torch_inverse.py); `python -m repro_torch.sweep invert
     specs/inverse_isocap.json --json` as a subprocess at the shipped 4
     starts x 120 iterations (the golden corner, grid_best_value within
     1e-12, best_value and standard_value within 1e-9 of the reference's,
     parity <= 1e-12, area within the budget, a strict win over the grid)
     and the same solve twice in process; the wide problem (INVERSE_WIDE:
     dtco_isoarea's 12 corners, 8 leaf groups, 64 leaves, one full chunk
     of 16 starts x 120 iterations): loss and gradient at the centres and
     at a seeded offset against the same lowering on the CPU (1e-12,
     1e-10 of the gradient's largest component), its solve (parity <=
     1e-12, within the budget, no worse than the grid), the elasticity
     table against the CPU's (1e-10 absolute, equal top knobs); solve
     seconds, start-steps/s, ms and host ms a step, device kernels a
     step, peak memory and the profiler's device-busy share of the
     descent, printed as an `{"inverse": ...}` line;
  9. after it, the dry run (`repro_torch.launch.dryrun`): the MLA
     backward's scratch size as its shape function reckons it against the
     library's; three cells at full width and depth (DRYRUN_CELLS:
     TinyLlama-1.1B train, RWKV6-3B and Hymba-1.5B prefill, 4 x 2048)
     traced under FakeTensorMode on fake CUDA tensors, then run for real,
     their arguments resident before `reset_peak_memory_stats`: argument
     bytes and FlopCounterMode totals equal, the predicted peak within
     DRYRUN_PEAK_REL + DRYRUN_PEAK_ABS of `max_memory_allocated`, the
     path's kernels launched by the real run and none by the trace, the
     output finite; TinyLlama's decode cell with the fp8 KV cache for
     real (half the bf16 cache's bytes, finite logits); then the dry run
     and roofline row of each DRYRUN_SWEEP cell (every shape kind and
     model family; `tools/dryrun_sweep.py` runs all 40), printed as a
     `{"dryrun": ...}` line.
Each phase's seconds are printed on a line of their own ("phase 5e
(...): N s"), and the sum last.  Prints one `{"kernels": [...]}` line
(the MLA backward as `flash_attention_bwd_mla`; Whisper's decoder shape
as `flash_attention_whisper` and `flash_attention_bwd_whisper`; Qwen3-14B's
and MiniCPM-2B's as `flash_attention_qwen3`, `flash_attention_minicpm`,
`flash_attention_bwd_qwen3` and `flash_attention_bwd_minicpm`), the
`{"served": ...}` (with `v3_train`, `whisper_train`, `qwen3_train` and
`minicpm_train`),
`{"pipeline": ...}`, `{"service": ...}`, `{"inverse": ...}` and
`{"dryrun": ...}` lines, the
card line, and last `{"ok": true, "device": {...}}`.  Exits non-zero,
without that last line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100's datasheet peaks: dense bf16 on the tensor cores, HBM3
from repro_torch.launch.roofline import PEAK_BF16_FLOPS, PEAK_BYTES  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
# Hymba-1.5B's prefill shapes (25 GQA-expanded heads of 64): its 29
# sliding-window layers (window 1024) and its 3 global ones
HYMBA_WINDOW = (4, 2048, 2048, 25, 64, True, 1024, 0, None)
HYMBA_GLOBAL = (4, 2048, 2048, 25, 64, True, None, 0, None)
# Whisper-small's decoder prefill and training shape (12 heads of 64)
WHISPER = (4, 2048, 2048, 12, 64, True, None, 0, None)
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
    HYMBA_WINDOW,
    HYMBA_GLOBAL,
    WHISPER,
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
# Qwen3-14B's prefill and training shape (40 heads of 128, its 8 kv heads
# expanded before the call), checked and timed in phase 5e
HD128 = (4, 2048, 2048, 40, 128, True, None, 0, None)
# the hd-128 shapes the DeepSeek-MoE 16B and Chameleon-34B prefills give
# the kernel (16 and 64 heads), timed beside SDPA
MOE_SHAPE = (4, 2048, 2048, 16, 128, True, None, 0, None)
VLM_SHAPE = (4, 2048, 2048, 64, 128, True, None, 0, None)
BWD_PARTS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
DENSE = ["tinyllama-1.1b", "qwen3-14b", "gemma-7b", "minicpm-2b",
         "chameleon-34b"]
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
# Served at every published width and full depth after Gemma-7B's
# training: DeepSeek-MoE 16B (~16.4 B params, 32.8 GB of bf16 weights) and
# Chameleon-34B (34.3 B, 68.6 GB); both through the flash forward at hd
# 128, one launch per layer (28, 48).  The fp32 MoE block at the MoE
# serve's prefill shape, card against CPU: the same experts and dropped
# (token, slot) pairs, the output within MOE_BLOCK_REL (relative max) and
# the load-balance loss within MOE_AUX_ABS
MOE_ARCH = "deepseek-moe-16b"
VLM_ARCH = "chameleon-34b"
MOE_BLOCK_REL = 1e-4
MOE_AUX_ABS = 1e-6
# DeepSeek-MoE 16B trained at every published width, its depth cut to the
# leading dense layer and 3 MoE layers: 2.27 B fp32 params (0.419 B of
# embedding and unembedding, 0.084 B the dense layer, 0.588 B a MoE layer)
# with grads, m and v ~36 GB, and the fp32 logits of 4 x 2048 tokens over
# 102400 entries 3.4 GB a copy.  Its step through the kernels is held
# against the plain twins at MOE_CHECK_LAYERS (1 dense + 2 MoE) by the
# naive oracle's distance, leaf by leaf (`train_vs_plain`)
MOE_TRAIN_LAYERS = 4
MOE_CHECK_LAYERS = 3
# DeepSeek-V3 served at every published width (d_model 7168, 128 heads,
# MLA: q rank 1536, kv rank 512, nope 128, rope 64, v 128; 256 routed
# experts top 8 of 2048 and 1 shared, 21 slots a group of 512; dense d_ff
# 18432; vocab 129280 untied), its depth cut to the 3 dense-lead layers and
# 2 MoE layers: 1.853 B params of embedding and unembedding, 0.584 B a
# dense-lead layer, 11.507 B a MoE layer, 0.686 B of MTP params, 27.3 B in
# all, ~54.6 GB of bf16 weights.  Its prefill attends through the flash
# forward at the MLA layout, one launch a layer; decode takes the naive
# absorbed branch.  One fp32 MLA block at full width (batch 1 x 2048, then
# a decode step) on the card against the CPU, within V3_MLA_REL
V3_ARCH = "deepseek-v3-671b"
V3_SERVE_LAYERS = 5
V3_MLA_REL = 1e-4
MLA_SCALE = (128 + 64) ** -0.5   # V3's qk_dim ** -0.5, not 576 ** -0.5
# The flash forward at the MLA layout against its plain twin (phase 2):
# (B, Sq, Skv, H, q_offset, v a view of k's first 512 features); q (B, Sq,
# H, 576), one k head of 576 and one v head of 512, causal, MLA_SCALE.  One
# head, three and V3's 128, v a view of k (as V3 serves it: the bf16
# kernel's K tile is its V tile) and a tensor of its own; a decode step at
# the end of the 2064-position cache, the prefill into it and a chunk
# prefilled at position 1900 of it; the bf16 kernel's 64-key tiles at 63 /
# 64 / 65 / 191 and the SIMT kernel's 32-key tiles at 127 / 129; both
# kernels' 64-row blocks (1 x 63, 3 x 65, ... rows)
MLA_CASES = [(2, sq, skv, h, q_offset, view)
             for h in (1, 3, 128) for view in (True, False)
             for sq, skv, q_offset in [(1, 1, 0), (63, 63, 0), (64, 64, 0),
                                       (65, 65, 0), (127, 127, 0),
                                       (129, 129, 0), (191, 191, 0),
                                       (1, 2064, 2063), (2048, 2064, 0),
                                       (100, 2064, 1900)]]
MLA_MAIN = (BATCH, PROMPT, PROMPT + GEN, 128, 0, True)   # V3's prefill
# The flash backward at the MLA layout, timed in bf16 at V3's training shape
# (batch 1 x 2048, 128 heads, v a view of k) and at batch 4
MLA_TRAIN = (1, PROMPT, PROMPT, 128, 0, True)
MLA_TRAIN_B4 = (BATCH, PROMPT, PROMPT, 128, 0, True)
# The backward's ragged head groups (it sums dK / dV over groups of 16
# heads): 20 heads, a group of 16 and one of 4, as MLA_CASES' tuples
MLA_BWD_EXTRA = [(2, 129, 191, 20, 62, False), (1, 300, 333, 20, 33, True)]
MLA_BWD_PARTS = ("flash_bwd_delta", "flash_bwd_mla_dk_bf16",
                 "flash_bwd_mla_sum", "flash_bwd_mla_dq_bf16")
# DeepSeek-V3 trained at every published width (as V3_SERVE_LAYERS says),
# batch 1 x 2048, its MTP head included, cut to what one 80 GB card holds
# for fp32 masters with grads and AdamW's m and v (16 B a param): 2 layers
# (1 dense-lead, 1 MoE; `first_dense_layers` set to 1, since a cut below
# V3's 3 would give the MoE segment a negative count) and the routed
# experts cut from 256 (11.27 B params a MoE layer, ~180 GB of state) to
# V3_TRAIN_EXPERTS: 1.853 B of embedding and unembedding, 0.584 B the
# dense-lead layer, 0.584 B the MoE layer, 0.686 B the MTP head, 3.707 B
# in all, 59.3 GB of state.  (At 16 experts, 4.059 B and 64.9 GB, AdamW's
# unfused temporaries for the 3.7 GB embedding table ran the H100 out of
# memory.)  Its step through the kernels is held against the plain twins
# at the same cut by the naive oracle's distance, leaf by leaf
# (`train_vs_plain`)
V3_TRAIN_LAYERS = 2
V3_TRAIN_EXPERTS = 8
V3_TRAIN_BATCH = 1
# Served after DeepSeek-V3: Hymba-1.5B (1.40 B params, 2.8 GB of bf16
# weights) at every published width and full depth, through the flash
# forward at hd 64 and 25 heads, one launch per layer (32, 29 of them with
# its 1024-key window), and the selective-scan kernel, one launch per layer
# and call (32 a prefill, 32 a decode step).  The fp32 SSM block at the
# serve's prefill shape, card against CPU: the output within SSM_BLOCK_REL
# (relative max), the new bf16 state within one bf16 ulp plus that
# (`bf16_state_close`).  Its prefill logits are held as `hybrid_logits_bar`
# says.  Then it trains at every published width and full depth (1.40 B
# fp32 params with grads, m and v ~22.5 GB, the fp32 logits of 4 x 2048
# tokens over 32001 entries 1.05 GB a copy), its step against the plain
# twins at HYMBA_CHECK_LAYERS layers (layer 0 global, 1-2 windowed): the
# plain loop's autograd graph saves h for every token, ~0.84 GB a layer.
HYMBA_ARCH = "hymba-1.5b"
SSM_BLOCK_REL = 1e-4
HYMBA_CHECK_LAYERS = 3
# Whisper-small, the encoder-decoder (arXiv:2212.04356 as the JAX package
# configures it: 12 encoder + 12 decoder layers, d_model 768, 12 heads x 64,
# d_ff 3072, vocab 51865, 1500 stub frame embeddings; 334.5 M params, 0.67 GB
# of bf16 weights), served and trained after Hymba-1.5B at every published
# width and full depth, its frames seeded bf16 normals (`whisper_frames`).
# The encoder's 1500 frames sit below FLASH_THRESHOLD and cross-attention is
# always naive, so only the decoder's causal self-attention reaches the
# flash kernels, at WHISPER (its prefill and training shape: one forward a
# decoder layer a prefill, 2 forwards and a backward a layer a step).  At
# the published decoder context of WHISPER_CONTEXT tokens (prompt
# WHISPER_CONTEXT - GEN, then GEN new ones) no kernel runs.
# The encoder's output on the card against the CPU is held in fp32 (the
# bf16 weights and frames upcast, one sequence) within WHISPER_ENC_REL
# (relative max): in bf16 the two devices' roundings through 12 layers
# alone came to 1.923e-2 (NVIDIA H100 80GB HBM3, 700 W).
WHISPER_ARCH = "whisper-small"
WHISPER_CONTEXT = 448
WHISPER_ENC_REL = 1e-4
# Last of the models (phase 5e), the two dense archs no other phase runs at
# full width: Qwen3-14B (14.768 B params: 40 layers, d_model 5120, 40 / 8
# heads x 128 with QK-norm, rope theta 1e6, d_ff 17408, an untied
# 151,936-entry vocabulary; 29.5 GB of bf16 weights) and MiniCPM-2B
# (2.725 B: 40 layers, d_model 2304, 36 heads x 64, d_ff 5760, a tied
# 122,753-entry table, residuals scaled by 1.4 / sqrt(40), the WSD
# schedule; 5.45 GB), each served at every published width and full
# depth through the flash forward at its prefill shape (HD128: Qwen3's GQA
# expanded before the call; MINICPM_SHAPE), one launch a layer.
# MiniCPM-2B trains at full depth, batch MINICPM_TRAIN_BATCH x 2048: 2.725
# B fp32 params with grads, m and v ~43.6 GB, the fp32 logits of 4 x 2048
# tokens over 122,753 entries 4.0 GB a copy.  Qwen3-14B trains at every
# published width, its depth cut to QWEN3_TRAIN_LAYERS at batch
# QWEN3_TRAIN_BATCH x 2048: its untied embedding and unembedding (1.556 B
# params) take 24.9 GB in fp32 with grads, m and v, a layer (0.330 B) 5.28
# GB, the fp32 logits of 2 x 2048 tokens over 151,936 entries 2.49 GB a
# copy.  Measured on the H100 (85.0 GB; 700 W): peaks of 61.666 GB at 4
# layers and 72.236 at 6, so 5.285 GB a layer above 40.53 GB for the rest
# (the tables' state, the logits, AdamW's unfused temporaries); 7 layers
# peak at 77.521 GB, 7.5 GB free, and 8 would leave 2.2 GB.
QWEN3_ARCH = "qwen3-14b"
MINICPM_ARCH = "minicpm-2b"
MINICPM_SHAPE = (4, 2048, 2048, 36, 64, True, None, 0, None)
MINICPM_TRAIN_BATCH = 4
# AdamW's kernels against the plain loop (tests/test_torch_cuda.py's
# ADAMW_REL: the loop's fp32 operations in its order with IEEE rounding;
# the clip scale and PyTorch's division by a Python float differ by ulps)
ADAMW_BAR = 1e-6
QWEN3_TRAIN_LAYERS = 7
QWEN3_TRAIN_BATCH = 2
# The selective scan's kernels against their plain twins (phase 2):
# (B, S, D, N, with_h0, strong).  S = 1 (a decode step), spans around the
# checkpoints (31, 32, 33, 65: CKPT_EVERY is 16), the chunks of CHUNK =
# 96 tokens that run in parallel (95, 96, 97 and 2048; 100, 186 and 236
# end in a ragged chunk); D = 64 (the reduced Hymba), 1600
# (Hymba-1.5B) and 77 (a block of 64 channels part empty, and rows that
# break 16-byte copies); N = 4 (reduced) and 16 (published).  `strong`
# draws dt in [6, 10], so exp(dt a) underflows to 0 in the upper states
# (a = -1 .. -N), and so does each chunk's carry.  y and h_last within
# SCAN_FWD_BAR (relative max) of the loop; every gradient as SCAN_BWD_BAR
# says, against `ref.ssm_scan_bwd_plain`.
SCAN_CASES = [
    (4, 1, 1600, 16, True, False),
    (2, 31, 64, 4, False, False),
    (2, 32, 64, 4, True, False),
    (2, 33, 1600, 16, True, False),
    (2, 65, 77, 4, True, False),
    (3, 100, 77, 16, False, True),
    (2, 95, 64, 4, True, False),
    (2, 96, 1600, 16, False, False),
    (2, 97, 64, 16, True, False),
    (2, 186, 77, 16, True, False),
    (2, 236, 77, 4, False, True),
    (4, 2048, 64, 4, True, False),
    (4, 2048, 1600, 16, False, False),
]
SCAN_MAIN = SCAN_CASES[-1]   # Hymba-1.5B's prefill and training shape
SCAN_FWD_BAR = 1e-5          # tests/test_torch_hymba.py's fp32 bar
SCAN_BWD_BAR = "|got - want| <= 1e-4 x max(max |want|, 1), each gradient"
# The H100's rate of MUFU.EX2 (each expf issues one): 16 results a clock an
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), 132 SMs at the SXM part's 1.98 GHz boost clock
PEAK_MUFU = 16 * 132 * 1.98e9
# Every launch counter, in the order the script reports them
COUNTERS = ("flash_attention", "flash_attention_mla", "flash_attention_bwd",
            "flash_attention_bwd_mla", "wkv6", "wkv6_bwd", "selective_scan",
            "selective_scan_bwd", "adamw", "adamw_leaves", "global_norm")
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
# RWKV6-3B trained at every published width and full depth (2.86 B fp32
# params with grads, m and v ~46 GB, plus the fp32 logits of 4 x 2048
# tokens over 65536 entries, 2.1 GB a copy); its step against the plain
# twins at RWKV_CHECK_LAYERS layers, since the plain recurrence's
# per-token autograd graph costs ~5.4 GB and ~1 s a layer at this shape
RWKV_TRAIN_BATCH = 4
RWKV_CHECK_LAYERS = 3

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
# The sweep service (phase 7) at the traffic of benchmarks/bench_serve.py:
# every golden below, SERVICE_COPIES clients each (32 concurrent requests,
# 3,696 cells a round); SERVICE_REPS timed rounds each way in process.
SERVICE_GOLDENS = ("isocap", "dtco", "dtco_isoarea", "lm_nvm")
SERVICE_COPIES = 8
SERVICE_REPS = 3
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
    "dtco_headline": {
        "sram": {
            "leak_w_first": 6.442749179585304,
            "leak_w_last": 13.368079484320571,
            "leak_growth": 2.0749029818946054,
        },
        "stt": {
            "leak_reduction_first": 5.627666571229109,
            "leak_reduction_last": 12.479898865599642,
            "edp_reduction_first": 2.018293759983032,
            "edp_reduction_last": 2.860295391021024,
        },
        "sot": {
            "leak_reduction_first": 10.700748930481616,
            "leak_reduction_last": 24.455026747618508,
            "edp_reduction_first": 3.8881181934244755,
            "edp_reduction_last": 5.755264468669321,
        },
    },
    "dtco_isoarea_headline": {
        "sram": {
            "leak_w_first": 6.442749179585304,
            "leak_w_last": 13.368079484320571,
            "leak_growth": 2.0749029818946054,
        },
        "stt": {
            "capacity_mb_first": 7.0,
            "capacity_mb_last": 7.0,
            "leak_reduction_first": 2.367589763308926,
            "leak_reduction_last": 5.331168579308886,
            "edp_reduction_first": 1.2103579836770761,
            "edp_reduction_last": 1.96178945416301,
        },
        "sot": {
            "capacity_mb_first": 10.0,
            "capacity_mb_last": 9.0,
            "leak_reduction_first": 3.585595312271066,
            "leak_reduction_last": 9.31422193251624,
            "edp_reduction_first": 2.1959387563857016,
            "edp_reduction_last": 4.2185013933407305,
        },
    },
    "table2_anchor_max_rel_err": 0.0003477563438318577,
}
# The inverse designer (phase 8).  The reference's grid winners of the two
# specs as iso-area EDP problems, and its solve of the shipped problem
# (specs/inverse_isocap.json, 4 starts x 120 iterations);
# tests/test_torch_inverse.py pins these to `repro.inverse` on the CPU.
# Bars: the grid within 1e-12, the solve's values within 1e-9 (120 Adam
# steps carry the last ulps of two implementations), parity <= 1e-12.
INVERSE_SOLVE_REL = 1e-9
INVERSE_GRAD_REL = 1e-10
# The wide problem: dtco_isoarea's 12 corners (8 leaf groups, 64 leaves),
# one full chunk of starts.
INVERSE_WIDE = dict(spec="dtco_isoarea", starts=16, iters=120)
INVERSE_GOLDEN = {
    "recover": {
        "isocap": {
            "corner": {"mem": "sot", "capacity_mb": 3.0,
                       "node": "16nm-finfet", "org_index": 2,
                       "org": "1b x 128r x 256c x sequential"},
            "value": 0.6287132765751648,
            "area_mm2": 1.950000577897137,
            "area_budget_mm2": 5.531051665241455,
        },
        "dtco_isoarea": {
            "corner": {"mem": "sot", "capacity_mb": 9.0,
                       "node": "7nm-scaled", "org_index": 2,
                       "org": "1b x 128r x 256c x sequential"},
            "value": 0.7183027158359055,
            "area_mm2": 0.9961391448539957,
            "area_budget_mm2": 5.6401255233758,
        },
    },
    "shipped": {
        "corner": {"mem": "sot", "capacity_mb": 3.0,
                   "node": "16nm-finfet", "org_index": 2,
                   "org": "1b x 128r x 256c x sequential"},
        "best_value": 0.47658224007809374,
        "standard_value": 0.47658224007809336,
        "grid_best_value": 0.6287132765751648,
        "area_budget_mm2": 5.531051665241455,
    },
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
            name = re.search(
                r"(?<=\d)(flash_[a-z0-9_]+?|wkv6_[a-z_]*kernel)[IE]"
                r"|(?<=\d)(ssm_scan_[a-z_]*kernel)[IE]"
                r"|(?<=\d)(adamw_kernel|norm_[a-z]+_kernel)[IE]", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            dt = ("bf16" if "__nv_bfloat16" in mangled else "f32"
                  if re.search(r"ILi\d+EfE|IfE", mangled) else "")
            label = name.group(name.lastindex) if name else mangled
            cur = {"kernel": f"{label}<"
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


def phase_seconds(label: str, t0: float) -> float:
    """Prints the seconds since t0 as phase `label`'s, on a line of its
    own; returns the time now, the next phase's t0."""
    now = time.perf_counter()
    print(f"phase {label}: {now - t0:.1f} s", flush=True)
    return now


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


def device_span(fn, name: str, calls: int, per_call: int):
    """(sum, span) in ms per call of fn, from torch.profiler over `calls`
    calls, each launching `per_call` kernels whose name holds `name`: their
    device time, and the time from the first one's start to the last one's
    end, which adds the gaps between them.  Both per call that the profile
    holds (a profile can lose the first calls' kernels); (None, None) where
    it holds none, or a count that no whole number of calls gives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.key]
    if not evts or len(evts) % per_call:
        return None, None
    held = len(evts) // per_call
    busy = sum(e.time_range.end - e.time_range.start for e in evts)
    span = (max(e.time_range.end for e in evts)
            - min(e.time_range.start for e in evts))
    return busy / 1e3 / held, span / 1e3 / held


def host_ms(fn, calls: int) -> float:
    """Host time (ms) of one call of fn: `calls` calls back to back after
    the device drained, without waiting for their device work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


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


def visible_pairs(sq, skv, causal, window, q_offset) -> int:
    """The (q, k) pairs that the mask leaves visible."""
    q_pos = torch.arange(sq, dtype=torch.int64)[:, None] + q_offset
    k_pos = torch.arange(skv, dtype=torch.int64)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return int(vis.sum())


def attn_flops(case) -> float:
    """The QK^T and PV operations of the visible (q, k) pairs."""
    b, sq, skv, h, hd = case[:5]
    causal, window, q_offset, _ = case[5:]
    return 4.0 * b * h * hd * visible_pairs(sq, skv, causal, window,
                                            q_offset)


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
    bf16 at the main path's shape, at Gemma-7B's serve and training
    shapes, at Hymba-1.5B's windowed prefill shape and at Whisper-small's
    decoder shape."""
    errs = {}
    for case in CASES:
        seen = seen_rows(case)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(case, dtype)
            err = check_forward(fa, ref, case, dtype, q, k, v, seen)
            _, bwd_err = check_backward(fa, case, dtype, q, k, v, seen)
            if (case in (MAIN, GEMMA, GEMMA_B2, HYMBA_WINDOW, WHISPER)
                    and dtype == torch.bfloat16):
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


def mla_qkv(case, dtype, seed=0) -> tuple:
    """q (B,Sq,H,576), k (B,Skv,1,576) and v (B,Skv,1,512) on the card at an
    MLA_CASES case; v a view of k's first 512 features where it says."""
    b, sq, skv, h, _, view = case
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(b, sq, h, 576, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, skv, 1, 576, generator=g, device="cuda").to(dtype)
    v = (k[..., :512] if view else
         torch.randn(b, skv, 1, 512, generator=g, device="cuda").to(dtype))
    return q, k, v


def check_mla_backward(fa, case, dtype, q, k, v) -> float:
    """Phase 2 for the backward at the MLA layout at one case: one launch
    of its own (and no other backward) a call, the kernels that ran
    (`fa.mla_bwd_kernel`: SIMT for fp32, wgmma for bf16, reading V from
    the K tiles where v is a view of k); dq, dk and dv against autograd of
    the plain twin on the same q, k, v (v's values, as a tensor of its
    own) and dO, within TOL[dtype] of max(max |want|, 1), as
    `check_backward` holds the other backwards; where v is a view of k,
    the fused call (`dv_into_dk`, as `FlashAttention` makes it) too: dq
    and k's whole gradient against the twin's dq and dk + [dv, 0] within
    the same bar, and no dv.  Returns the worst relative max error."""
    kw = dict(causal=True, q_offset=case[4], scale=MLA_SCALE)
    g = torch.Generator("cuda").manual_seed(7)
    do = torch.randn(*q.shape[:3], 512, generator=g, device="cuda").to(dtype)
    kernel = fa.mla_bwd_kernel(q, k, v, do)
    meant = ("simt" if dtype == torch.float32
             else "wgmma_kv" if case[5] else "wgmma")
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    fused = (fa.flash_attention_bwd(q, k, v, out, do, lse, dv_into_dk=True,
                                    **kw) if case[5] else None)
    launched = (fa.flash_attention_bwd.launches - before[0],
                fa.flash_attention_bwd.launches_mla - before[1])
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, **kw).backward(do)
    torch.cuda.synchronize()
    errs = [rel_err(a, b.grad, floor=1.0) for a, b in zip(got, (qr, kr, vr))]
    fused_errs = []
    if fused is not None:
        whole = kr.grad.clone()
        whole[..., :512] += vr.grad
        fused_errs = [rel_err(fused[0], qr.grad, floor=1.0),
                      rel_err(fused[1], whole, floor=1.0)]
    ok = (launched == (0, 1 + (fused is not None)) and kernel == meant
          and all(torch.isfinite(t).all().item() for t in got)
          and (fused is None or (fused[2] is None and all(
              torch.isfinite(t).all().item() for t in fused[:2])))
          and max(errs + fused_errs) <= TOL[dtype])
    print(json.dumps({"mla_bwd_case": list(case), "dtype": str(dtype),
                      "kernel": kernel, "rel_max_err_dq_dk_dv": errs,
                      "fused_rel_max_err_dq_dk": fused_errs,
                      "tol": TOL[dtype], "launches": launched, "ok": ok}),
          flush=True)
    if not ok:
        fail(f"flash_attention_bwd at the MLA layout {case} {dtype}: errors "
             f"{errs}, fused {fused_errs}, launches {launched}, kernel "
             f"{kernel} (want {meant})")
    return max(errs + fused_errs)


def check_mla(fa, ref, ops) -> None:
    """Phase 2 for the flash forward and backward at the MLA layout, over
    MLA_CASES in fp32 and bf16: the forward's one launch of its own kernel
    a call, its output within TOL[dtype] (max abs) and lse within 1e-4
    (relative max) of the plain twin's, the kernel that ran
    (`fa.mla_kernel`) the SIMT kernel for fp32 and the wgmma kernel for
    bf16 (its K tile as V where v is a view of k); the backward as
    `check_mla_backward` says, also at MLA_BWD_EXTRA's 20 heads; two
    backward calls bitwise equal at V3's training shape (bf16, v a view of
    k) and at a ragged fp32 case of 20 heads; and
    `ops.attention` under grad at 2048 positions (v a view of k, as
    `mla_attention` passes it) giving an output whose backward launches
    the MLA backward once, with q's and k's gradients (dv added into k's
    by autograd) within the bf16 bar of autograd of the plain twin."""
    for case in MLA_CASES:
        kw = dict(causal=True, q_offset=case[4], scale=MLA_SCALE)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = mla_qkv(case, dtype)
            kernel = fa.mla_kernel(q, k, v)
            meant = ("simt" if dtype == torch.float32
                     else "wgmma_kv" if case[5] else "wgmma")
            before = fa.flash_attention.launches_mla
            got, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
            launched = fa.flash_attention.launches_mla - before
            want, want_lse = ref.flash_fwd(q, k, v, min(512, case[2]), **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            lse_err = rel_err(lse, want_lse)
            ok = (launched == 1 and got.shape == want.shape
                  and torch.isfinite(got).all().item() and err <= TOL[dtype]
                  and lse_err <= 1e-4 and kernel == meant)
            print(json.dumps({"mla_case": list(case), "dtype": str(dtype),
                              "kernel": kernel,
                              "max_abs_err": err, "tol": TOL[dtype],
                              "lse_rel_max_err": lse_err, "lse_tol": 1e-4,
                              "ok": ok}), flush=True)
            if not ok:
                fail(f"flash_attention at the MLA layout {case} {dtype}: "
                     f"error {err}, lse {lse_err}, launches {launched}, "
                     f"kernel {kernel} (want {meant})")
            del got, want, lse, want_lse
            check_mla_backward(fa, case, dtype, q, k, v)
            del q, k, v
    for case in MLA_BWD_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            check_mla_backward(fa, case, dtype, *mla_qkv(case, dtype))
    for case, dtype in ((MLA_TRAIN, torch.bfloat16),
                        (MLA_BWD_EXTRA[0], torch.float32)):
        q, k, v = mla_qkv(case, dtype)
        kw = dict(causal=True, q_offset=case[4], scale=MLA_SCALE)
        do = torch.randn(*q.shape[:3], 512, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(7)
                         ).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
        first = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        second = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        print(json.dumps({"mla_bwd_deterministic": list(case),
                          "dtype": str(dtype),
                          "bitwise_equal_dq_dk_dv": same}), flush=True)
        if not all(same):
            fail(f"flash_attention_bwd at the MLA layout {case}: two calls "
                 f"differ ({same})")
        del q, k, v, do, out, lse, first, second
    q, k, _ = mla_qkv((2, PROMPT, PROMPT + GEN, 3, 0, True), torch.bfloat16)
    q.requires_grad_()
    k.requires_grad_()
    out = ops.attention(q, k, k[..., :512], scale=MLA_SCALE)
    do = torch.randn(out.shape, device="cuda", dtype=out.dtype,
                     generator=torch.Generator("cuda").manual_seed(7))
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    got = torch.autograd.grad(out, (q, k), do)
    launched = (fa.flash_attention_bwd.launches - before[0],
                fa.flash_attention_bwd.launches_mla - before[1])
    want = torch.autograd.grad(fa.flash_attention_plain(
        q, k, k[..., :512], scale=MLA_SCALE), (q, k), do)
    errs = [rel_err(a, b, floor=1.0) for a, b in zip(got, want)]
    print(f"the MLA layout under grad through ops.attention: grad_fn "
          f"{type(out.grad_fn).__name__}, backward launches (other, MLA) "
          f"{launched}, dq / dk (dv added) vs the plain twin's "
          f"{errs}", flush=True)
    if (out.grad_fn is None or launched != (0, 1)
            or max(errs) > TOL[torch.bfloat16]):
        fail(f"ops.attention at the MLA layout under grad: grad_fn "
             f"{out.grad_fn}, launches {launched}, errors {errs}")
    del q, k, out, do, got, want


def mla_bound(case) -> tuple[float, str]:
    """Least time (ms) of the MLA-layout forward in bf16: q, k, v read and
    o written once, against QK^T over 576 features and PV over 512 for
    each visible pair, head and sequence."""
    b, sq, skv, h, q_offset, _ = case
    flops = (2.0 * (576 + 512) * b * h
             * visible_pairs(sq, skv, True, None, q_offset))
    nbytes = 2 * (b * sq * h * (576 + 512) + b * skv * (576 + 512))
    return roofline(flops, nbytes, PEAK_BF16_FLOPS)


def time_flash_mla(fa, card) -> tuple:
    """Phase 4a for the MLA layout at V3's prefill shape (MLA_MAIN, bf16,
    v a view of k): the kernel against its plain twin (max abs, held to
    2e-2) and both timed, beside `scaled_dot_product_attention` given k
    and v expanded to 128 heads (a yardstick the port never calls; its
    output held to the kernel's within 0.1, a check of the mask), with the
    bound; then the fp32 SIMT kernel at the same shape against the bf16
    kernel's inputs in fp32 (within 2e-2 of the bf16 output), timed; and
    both kernels' registers and spills from ptxas.  Returns (ms, plain_ms,
    sdpa_ms or None, bound_ms, bound_by, max abs err, fp32 ms)."""
    from repro_torch.kernels import build
    for row in ptxas_report(build.log("flash_attention")):
        if "flash_fwd_mla" in row["kernel"]:
            print(f"  {row['kernel']}: {row['registers']} registers, "
                  f"{row['spill']} bytes spill stores", flush=True)
    q, k, v = mla_qkv(MLA_MAIN, torch.bfloat16)
    kw = dict(causal=True, q_offset=MLA_MAIN[4], scale=MLA_SCALE)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        del want
        if err > TOL[torch.bfloat16]:
            fail(f"flash_attention at the MLA layout {MLA_MAIN}: {err}")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 10, warmup=1)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2,
                           warmup=1)
        h = MLA_MAIN[3]
        qt = q.transpose(1, 2)
        kt, vt = (x.expand(-1, -1, h, -1).transpose(1, 2) for x in (k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=MLA_SCALE)
        try:
            lib_err = (sdpa().transpose(1, 2).float()
                       - got.float()).abs().max().item()
            rows = device_kernels(sdpa)
            lib_ms = time_ms(sdpa, 5, warmup=1)
            how = (f"sdpa {lib_ms:.4f} ms (kernel that ran: "
                   f"{max(rows, key=lambda e: e.self_device_time_total).key[:80] if rows else 'not measured'}; "
                   f"vs kernel max abs err {lib_err:.3e})")
            if lib_err > 0.1:
                fail(f"SDPA at the MLA layout differs from the kernel: "
                     f"{lib_err}")
        except RuntimeError as ex:
            lib_ms, how = None, f"sdpa: none ({str(ex)[:200]})"
    bound_ms, bound_by = mla_bound(MLA_MAIN)
    b, sq, skv, h, q_offset, _ = MLA_MAIN
    gflop = 2 * (576 + 512) * b * h * visible_pairs(sq, skv, True, None,
                                                    q_offset) / 1e9
    print(f"flash_attention at the MLA layout {MLA_MAIN[:4]} (576 / 512, "
          f"v a view of k) bf16 causal: kernel {ms:.4f} ms ("
          f"{gflop / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, {how}, "
          f"bound {bound_ms:.4f} ms ({bound_by}); kernel vs plain max abs "
          f"err {err:.3e} [{card}]", flush=True)
    del qt, kt, vt
    q32, k32 = q.float(), k.float()
    v32 = k32[..., :512]
    del q, k, v
    with torch.no_grad():
        got32 = fa.flash_attention(q32, k32, v32, **kw)
        err32 = (got32 - got.float()).abs().max().item()
        if err32 > TOL[torch.bfloat16]:
            fail(f"the fp32 MLA kernel at {MLA_MAIN} differs from the bf16 "
                 f"kernel: {err32}")
        ms32 = time_ms(lambda: fa.flash_attention(q32, k32, v32, **kw), 3,
                       warmup=1)
    print(f"flash_attention at the MLA layout {MLA_MAIN[:4]} fp32 causal "
          f"(SIMT): {ms32:.4f} ms ({gflop / ms32:.1f} TFLOP/s; fp32 peak "
          f"outside the tensor cores 67 TFLOP/s), vs the bf16 kernel max "
          f"abs {err32:.3e} [{card}]", flush=True)
    del q32, k32, v32, got32, got
    torch.cuda.empty_cache()
    return ms, plain_ms, lib_ms, bound_ms, bound_by, err, ms32


def mla_bwd_bound(case) -> tuple[float, str]:
    """Least time (ms) of the MLA-layout backward in bf16: q, k, v, o, dO
    and lse read and dq, dk, dv written once, against the five products
    over each visible pair, head and sequence (S 576, dP 512, dQ 576, dK
    576, dV 512 multiply-adds)."""
    b, sq, skv, h, q_offset, _ = case
    flops = (2.0 * 2752 * b * h
             * visible_pairs(sq, skv, True, None, q_offset))
    nbytes = 2 * (b * sq * h * 2176 + b * skv * 2176) + 4 * b * h * sq
    return roofline(flops, nbytes, PEAK_BF16_FLOPS)


def time_flash_mla_bwd(fa, ref, card) -> dict:
    """Phase 4a for the backward at the MLA layout, bf16 causal, v a view
    of k, at V3's training shape MLA_TRAIN and at MLA_TRAIN_B4: the call as
    the main path makes it (`FlashAttention` asks for k's whole gradient,
    `dv_into_dk`: its four launches) by CUDA events, against its plain
    twin's fused form (max abs of dq and dk + [dv, 0], held to the
    backward's bar) and timed, beside SDPA's backward given k and v
    expanded to 128 heads (forward and backward less its forward; a
    yardstick the port never calls), with the bound and the achieved
    TFLOP/s of the bound's five products; at MLA_TRAIN also the call that
    returns dk and dv apart (five launches), and each launch's device time
    by profiler.  Returns {case: (ms, plain_ms, sdpa_ms or None, bound_ms,
    bound_by, max abs err)}."""
    out_rows = {}
    for case, iters in ((MLA_TRAIN, 5), (MLA_TRAIN_B4, 3)):
        q, k, v = mla_qkv(case, torch.bfloat16)
        kw = dict(causal=True, q_offset=case[4], scale=MLA_SCALE,
                  dv_into_dk=True)
        do = torch.randn(*q.shape[:3], 512, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(7)
                         ).bfloat16()
        out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True,
                                          causal=True, q_offset=case[4],
                                          scale=MLA_SCALE)
        args = (q, k, v, out, do, lse)
        got = fa.flash_attention_bwd(*args, **kw)
        want = ref.flash_attention_bwd_plain(*args, min(512, case[2]), **kw)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got[:2], want[:2]))
        rel = max(rel_err(a, b, floor=1.0) for a, b in zip(got[:2], want[:2]))
        del got, want
        if rel > TOL[torch.bfloat16]:
            fail(f"flash_attention_bwd at the MLA layout {case}: {rel}")
        ms = time_ms(lambda: fa.flash_attention_bwd(*args, **kw), iters,
                     warmup=1)
        plain_ms = time_ms(lambda: ref.flash_attention_bwd_plain(
            *args, min(512, case[2]), **kw), 2, warmup=1)
        apart = ""
        if case == MLA_TRAIN:
            kw_apart = {**kw, "dv_into_dk": False}
            apart_ms = time_ms(lambda: fa.flash_attention_bwd(
                *args, **kw_apart), iters, warmup=1)
            apart = f", dk and dv apart (five launches) {apart_ms:.4f} ms"
        b, sq, skv, h, q_offset, _ = case
        qt = q.transpose(1, 2).detach().requires_grad_()
        kb = k.detach().requires_grad_()
        dot = do.transpose(1, 2)

        def sdpa():
            kt = kb.expand(-1, -1, h, -1).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, kt[..., :512], is_causal=True, scale=MLA_SCALE)
        try:
            both = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kb), dot),
                           iters, warmup=1)
            lib_ms = both - time_ms(sdpa, iters, warmup=1)
            how = f"sdpa backward {lib_ms:.4f} ms (forward + backward {both:.4f})"
        except RuntimeError as ex:
            lib_ms, how = None, f"sdpa backward: none ({str(ex)[:200]})"
        del qt, kb, dot
        bound_ms, bound_by = mla_bwd_bound(case)
        tflop = (2 * 2752 * b * h
                 * visible_pairs(sq, skv, True, None, q_offset) / 1e12)
        print(f"flash_attention_bwd at the MLA layout {case[:4]} (576 / 512, "
              f"v a view of k) bf16 causal: kernel {ms:.4f} ms "
              f"({tflop * 1e3 / ms:.1f} TFLOP/s of the bound's {tflop:.3f} "
              f"TFLOP){apart}, plain {plain_ms:.4f} ms, {how}, bound "
              f"{bound_ms:.4f} ms ({bound_by}); kernel vs plain max abs err "
              f"{err:.3e}, relative {rel:.3e} [{card}]", flush=True)
        if case == MLA_TRAIN:
            # a profile late in a long run can come back without the
            # launches (seen once in the full script): up to three windows
            for _ in range(3):
                rows = [e for e in device_kernels(
                    lambda: [fa.flash_attention_bwd(*args, **kw)
                             for _ in range(3)]) if "flash_bwd" in e.key]
                if rows:
                    break
            parts = []
            for name in MLA_BWD_PARTS:
                hit = [e for e in rows if name in e.key]
                part_ms = (sum(e.self_device_time_total for e in hit) / 1e3
                           / max(1, sum(e.count for e in hit)))
                parts.append(f"{name} {part_ms:.4f} ms" if hit
                             else f"{name} not measured")
            print(f"flash_attention_bwd at the MLA layout {case[:4]} bf16, "
                  f"device time per launch (profiler): {', '.join(parts)} "
                  f"[{card}]", flush=True)
        out_rows[case] = (ms, plain_ms, lib_ms, bound_ms, bound_by, err)
        del q, k, v, do, out, lse, args
        torch.cuda.empty_cache()
    return out_rows


def window_mask(case):
    """(Sq, Skv) bool on the card: causal within the case's window, the
    mask SDPA is given for a windowed case."""
    q_pos = torch.arange(case[1], device="cuda")[:, None]
    k_pos = torch.arange(case[2], device="cuda")[None, :]
    return (q_pos >= k_pos) & (q_pos - k_pos < case[6])


def time_flash(fa, case, card) -> tuple:
    """Phase 4a for one causal bf16 shape: the kernel, its plain twin and
    `scaled_dot_product_attention` (a yardstick the port never calls) on the
    same inputs, with the bound and the achieved TFLOP/s on the visible
    pairs.  SDPA has no window: a windowed case gives it the mask as a
    boolean `attn_mask`, its output is held to the kernel's within 0.1 (a
    check of the mask, not of either rounding) and the kernel it ran is
    named (the backend: flash, memory-efficient,
    cuDNN or math).  Returns (ms, plain_ms, sdpa_ms, bound_ms,
    bound_by)."""
    q, k, v = qkv(case, torch.bfloat16)
    kw = attn_kwargs(case)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    window = kw["window"]
    if window is None:
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
        how = ""
    else:
        mask = window_mask(case)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
        err = (sdpa().transpose(1, 2).float()
               - fa.flash_attention(q, k, v, **kw).float()).abs().max().item()
        rows = device_kernels(sdpa)
        ran = (max(rows, key=lambda e: e.self_device_time_total).key[:80]
               if rows else "not measured")
        how = (f" (window {window} as a boolean attn_mask; the SDPA kernel "
               f"that ran: {ran}; SDPA vs kernel max abs err {err:.3e})")
        if err > 0.1:   # a mask that is not the window's moves rows by O(1)
            fail(f"SDPA with the window mask differs from the kernel at "
                 f"{case}: {err}")
    lib_ms = time_ms(sdpa, 20)
    bound_ms, bound_by = bound(case, torch.bfloat16)
    tflops = attn_flops(case) / 1e9
    print(f"flash_attention {case[:5]} bf16 causal: kernel {ms:.4f} ms "
          f"({tflops / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms ({tflops / lib_ms:.1f} TFLOP/s){how}, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {tflops:.1f} GFLOP) [{card}]",
          flush=True)
    return ms, plain_ms, lib_ms, bound_ms, bound_by


def timing(t: tuple) -> dict:
    """`time_flash`'s or `time_flash_bwd`'s tuple as the `kernels` line's
    keys."""
    return dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                    t))


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
    three launches), its plain twin and SDPA's backward (the backward of
    one SDPA forward's retained graph, timed alone; a yardstick the port
    never calls; a windowed case gives it the window as a boolean mask)
    on the same inputs, with the bound.  Returns (ms, plain_ms, sdpa_ms,
    bound_ms, bound_by)."""
    args, kw = bwd_inputs(fa, case)
    q, k, v, out, do, lse = args
    ms = time_ms(lambda: fa.flash_attention_bwd(*args, **kw), 5)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_plain(
        q, k, v, out, do, lse, min(512, case[2]), **kw), 3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    mask = None if kw["window"] is None else window_mask(case)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None)
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                      20)
    # SDPA's backward alone: one forward's graph kept, its backward timed
    # by itself, and its device time by profiler with the kernel that ran
    # (forward + backward less the forward, timed apart, is printed beside
    # it)
    kept = sdpa()

    def backward():
        return torch.autograd.grad(kept, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_ms = time_ms(backward, 20)
    rows = device_kernels(lambda: [backward() for _ in range(10)])
    dev = "not measured"
    if rows:   # per call that the profile holds (it can lose the first
        # calls' kernels): the heaviest kernel runs once a call
        top = max(rows, key=lambda e: e.self_device_time_total)
        per = sum(e.self_device_time_total for e in rows) / 1e3 / top.count
        dev = (f"{per:.4f} ms over {top.count} calls, heaviest "
               f"{top.key[:60]}")
    diff_ms = both_ms - time_ms(sdpa, 20)
    del kept
    bound_ms, bound_by = bwd_bound(case, torch.bfloat16)
    tflops = 2.5 * attn_flops(case) / 1e9
    label = "" if mask is None else f", window {kw['window']} (SDPA: mask)"
    print(f"flash_attention_bwd {case[:5]} bf16 causal{label}: kernel "
          f"{ms:.4f} ms ({tflops / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          "sdpa "
          f"backward {lib_ms:.4f} ms (its retained graph's backward alone; "
          f"device time by profiler {dev}; forward + backward "
          f"{both_ms:.4f}, less the forward {diff_ms:.4f}), "
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
    """Batches 0..n-1 of the training data pipeline, on the card; for an
    encoder-decoder each also carries "frames", (batch, n_frames, d_model)
    standard normal from a generator seeded with the batch's index, in
    bf16 (`whisper_frames`)."""
    from repro_torch.data import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    out = [{k: torch.from_numpy(a).to("cuda", torch.long)
            for k, a in data.batch(i).items()} for i in range(n)]
    if cfg.encdec is not None:
        for i, b in enumerate(out):
            b["frames"] = whisper_frames(cfg, batch, seed=100 + i)
    return out


def whisper_frames(cfg, batch: int, seed: int = 0, device="cuda"):
    """Stub frame embeddings (batch, n_frames, d_model): standard normal
    from a seeded generator on `device`, in bf16, as tests/test_models.py
    draws them."""
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn((batch, cfg.encdec.n_frames, cfg.d_model),
                       generator=g, device=device).bfloat16()


def counts(**launches) -> dict:
    """A run's wanted launch counts: those given, every other counter 0."""
    return {name: launches.get(name, 0) for name in COUNTERS}


def set_counts(counters) -> None:
    """`counters`: {name: (wrapper, attribute)}, each a launch count."""
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def optimizer_counts(state) -> dict:
    """The AdamW kernels' counts of one `make_train_step` step over
    `state` (fp32 grads): the update's launches and leaves, and the
    launches of two norms (the clip's and the metrics')."""
    from repro_torch.kernels import adamw as aw
    ps = tree_leaves(state.params)
    numels = [p.numel() for p in ps]
    upd = aw.plan([(p.dtype, torch.float32) for p in ps], numels,
                  aw.MAX_LEAVES)
    norm = aw.plan([torch.float32] * len(ps), numels, aw.MAX_NORM_LEAVES)
    return {"adamw": len(upd), "adamw_leaves": len(ps),
            "global_norm": 2 * (len(norm) + 1)}


def train_path(card, cfg, batch: int, train, counters, fixed=None) -> dict:
    """Phase 3 for training: `build_trainer` on `cfg` at batch x PROMPT, a
    warm-up step, then TRAIN_STEPS steps, each with the counts set to 0
    just before it and read just after (and checked: a flash forward per
    layer and its recompute and a backward per layer; at the MLA layout
    also one forward and one backward for the MTP block, which is not
    recomputed).  `fixed(params)`, if given, lists leaves that every step
    must leave bitwise where they were.  Returns the numbers for the
    report: the median step time and one step's launches, as the serve
    phases report one serve's, the params and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, step, _ = train.build_trainer(cfg, device="cuda", remat="full")
    n_params = sum(t.numel() for t in tree_leaves(state.params)) / 1e9
    held = ([t.detach().clone() for t in fixed(state.params)]
            if fixed is not None else [])
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
    print(f"train {cfg.name} ({cfg.n_layers} layers, {n_params:.3f} B "
          f"params) batch {batch} x seq "
          f"{PROMPT}, fp32 masters, remat full: setup and warm-up step "
          f"{setup_s:.3f}s; steps {', '.join(f'{t:.3f}' for t in times)} ms "
          f"(median {step_ms:.3f} ms, {batch * PROMPT * 1e3 / step_ms:.1f} "
          f"tokens/s); peak memory {peak_gb:.3f} GB; losses {losses}; "
          f"launches per step {per_step} [{card}]", flush=True)
    n = cfg.n_layers
    mtp = int(cfg.mtp)
    opt = optimizer_counts(state)
    want = (counts(wkv6=2 * n, wkv6_bwd=n, **opt) if cfg.rwkv else counts(
        flash_attention_mla=2 * n + mtp, flash_attention_bwd_mla=n + mtp,
        **opt) if cfg.mla is not None else counts(
        flash_attention=2 * n, flash_attention_bwd=n, **opt,
        **({"selective_scan": 2 * n, "selective_scan_bwd": n}
           if cfg.ssm is not None else {})))
    if any(c != want for c in per_step):
        fail(f"train {cfg.name} launched {per_step}; want {want} a step (a "
             "forward per layer, its recompute, and a backward per layer, "
             "and the MTP block's forward and backward; AdamW's kernels "
             "over every leaf)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {cfg.name}: a loss is not finite: {losses}")
    if fixed is not None:
        same = [torch.equal(a, b) for a, b in zip(fixed(state.params), held)]
        print(f"train {cfg.name}: {len(same)} fixed leaves bitwise unchanged "
              f"after {TRAIN_STEPS + 1} steps: {all(same)}", flush=True)
        if not (same and all(same)):
            fail(f"train {cfg.name}: a fixed leaf moved ({same})")
    rows = device_kernels(lambda: step(state, batches[-1]))
    report_busy(f"{cfg.name} train step", rows, step_ms, 1, top=12)
    fwd_rows = [e for e in rows if "flash_fwd" in e.key]
    if fwd_rows:   # the flash forward's share of the step (with remat)
        fwd_ms = sum(e.self_device_time_total for e in fwd_rows) / 1e3
        print(f"{cfg.name} train step: the flash forward {fwd_ms:.3f} ms of "
              f"device time x{sum(e.count for e in fwd_rows)}, "
              f"{100 * fwd_ms / step_ms:.1f} % of the {step_ms:.3f} ms step "
              f"[{card}]", flush=True)
    bwd_rows = [e for e in rows if "flash_bwd" in e.key]
    if bwd_rows:   # the flash backward's share of the step, by launch
        bwd_ms = sum(e.self_device_time_total for e in bwd_rows) / 1e3
        print(f"{cfg.name} train step: the flash backward {bwd_ms:.3f} ms "
              f"of device time, {100 * bwd_ms / step_ms:.1f} % of the "
              f"{step_ms:.3f} ms step (" + ", ".join(
                  f"{re.search(r'flash_bwd_[a-z_0-9]+(<[^>]*>)?', e.key)[0]} "
                  f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in bwd_rows) + f") [{card}]", flush=True)
    scan_rows = [e for e in rows if "ssm_scan" in e.key]
    if scan_rows:   # the selective scan's share of the step, by kernel
        scan_ms = sum(e.self_device_time_total for e in scan_rows) / 1e3
        print(f"{cfg.name} train step: the selective scan {scan_ms:.3f} ms "
              f"of device time, {100 * scan_ms / step_ms:.1f} % of the "
              f"{step_ms:.3f} ms step (" + ", ".join(
                  f"{re.search(r'ssm_scan_[a-z]+_kernel', e.key)[0]} "
                  f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in scan_rows) + f") [{card}]", flush=True)
    for label, part in wkv6_parts(rows).items():
        if part:   # the wkv6 kernels' share of the step
            part_ms = sum(e.self_device_time_total for e in part) / 1e3
            print(f"{cfg.name} train step: the wkv6 {label} {part_ms:.3f} ms "
                  f"of device time, {100 * part_ms / step_ms:.1f} % of the "
                  f"{step_ms:.3f} ms step (" + ", ".join(
                      f"{wkv6_name(e.key)} {e.self_device_time_total / 1e3:.3f}"
                      f" ms x{e.count}" for e in part) + f") [{card}]",
                  flush=True)
    del state
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "launches": per_step[0], "peak_gb": peak_gb,
            "tokens_per_s": batch * PROMPT * 1e3 / step_ms, "losses": losses,
            "params_b": n_params}


def leaf_names(tree, prefix: str = "") -> list:
    """"/a/0/b" for every leaf of nested dicts and lists, in
    `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def fp32_loss(cfg, lm, params, batch):
    """`LM.loss` in fp32 activations through the plain twins, no remat:
    the embedding gathered in fp32, every block at force="plain"."""
    from repro_torch.models import layers
    scale = cfg.d_model ** 0.5 if cfg.embed_scale_by_dim else 1.0
    x = layers.embed(params["embed"], batch["tokens"], scale,
                     dtype=torch.float32)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    for i, seg in enumerate(lm.layer_plan(cfg)):
        for lp in params[f"seg{i}"]:
            x, _ = lm._apply_block(lp, cfg, seg, x, pos, force="plain")
    logits = layers.unembed(params["embed"],
                            layers.rmsnorm(params["ln_f"], x),
                            cap=cfg.logit_cap or None)
    return layers.cross_entropy(logits, batch["labels"])


def fp32_distances(card, cfg, lm, params, batch, kernel, plain) -> None:
    """Beside a hybrid model's training-step bar: from the same params and
    batch, a step in fp32 activations through the plain twins
    (`fp32_loss`), and how far the kernels' and the plain twins' loss and
    gradient leaves (relative L2) lie from it: the twins' own bf16
    drift, against which the bar's margin reads."""
    leaves = tree_leaves(params)
    loss = fp32_loss(cfg, lm, params, batch)
    loss_f, gf = loss.item(), torch.autograd.grad(loss, leaves)
    del loss
    names = leaf_names(params)
    parts = []
    for label, (loss_x, gx) in (("kernel", kernel), ("plain", plain)):
        dist = [rel_l2(a, b) for a, b in zip(gx, gf)]
        worst = max(range(len(dist)), key=dist.__getitem__)
        parts.append(f"{label}: loss {abs(loss_x - loss_f) / abs(loss_f):.3e}"
                     f", leaves worst {dist[worst]:.3e} ({names[worst]}), "
                     f"median {sorted(dist)[len(dist) // 2]:.3e}")
    print(f"{cfg.name} train step from fp32 activations (plain twins, loss "
          f"{loss_f:.6f}), relative: {'; '.join(parts)} [{card}]",
          flush=True)


@contextlib.contextmanager
def routing_picks(picks: list):
    """While open, each MoE layer's call of `blocks.route` appends its
    tokens' chosen experts (sorted, (G, S_g, K)) to `picks`."""
    from repro_torch.models import blocks
    real = blocks.route

    def route(*args):
        out = real(*args)
        picks.append(out[1].sort(dim=-1).values)
        return out
    blocks.route = route
    try:
        yield picks
    finally:
        blocks.route = real


def moved_tokens(a: list, b: list) -> list:
    """Per MoE layer, the tokens whose chosen experts differ."""
    return [int((x != y).any(dim=-1).sum()) for x, y in zip(a, b)]


def train_vs_plain(card, cfg, batch_size: int, lm) -> None:
    """Phase 4 for training: from the same fp32 params and batch, the loss
    and every gradient leaf of one step of `cfg` through the kernels
    against the same through the plain twins (autograd of
    `ref.flash_attention_ref`, the wkv6 and scan loops).  The loss within
    2e-2 relative; each leaf's relative L2 error within GRAD_BAR (see
    there).  For a MoE model, whose routing turns bf16 rounding into other
    experts, a third step through the naive oracle sets the bars: the loss
    within max(2e-2, 1.5 x the oracle's distance from the plain step), each
    leaf within max(GRAD_BAR, 1.5 x the oracle's distance on that leaf);
    the tokens whose experts differ between the kernel's and the plain
    step are counted by MoE layer, and the five leaves nearest their bars
    printed.  For an encoder-decoder, every step's encoder takes the
    kernel step's path (naive attention: no kernel runs there), and the
    five leaves nearest their bars are printed with the worst of the
    encoder's and of the cross-attention's.  For a hybrid model, whose normed mixing carries bf16
    rounding from layer to layer, both steps' distances from fp32
    activations are printed beside it (`fp32_distances`)."""
    params = lm.build(cfg).init(torch.Generator("cuda").manual_seed(0),
                                dtype=torch.float32)
    leaves = tree_leaves(params)
    names = leaf_names(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = train_batches(cfg, 1, batch_size)[0]
    losses, dist, picks = {}, {}, {}
    oracle = cfg.moe is not None
    # the plain step first; each other step is held against it and dropped
    # (the kernels' kept for a hybrid's fp32 distances), so at most two
    # sets of gradients share the card
    for force in ("plain", None) + (("naive",) if oracle else ()):
        model = lm.build(cfg, force=force, remat="full")
        if cfg.encdec is not None:
            # the encoder (its frames below FLASH_THRESHOLD) runs no kernel:
            # every step takes the kernel step's naive path there, so the
            # steps differ only where the kernels run (`force` would send
            # the encoder's attention through the chunked twin instead)
            model.encode = lm.build(cfg, remat="full").encode
        with routing_picks(picks.setdefault(force, [])):
            loss = model.loss(params, batch)
        losses[force] = loss.item()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        del loss
        if force == "plain":
            gp = grads
            continue
        dist[force] = [rel_l2(a, b) for a, b in zip(grads, gp)]
        if force is None:
            worst_max = max(rel_err(a, b) for a, b in zip(grads, gp))
            gk = grads if cfg.ssm is not None else None
        del grads
    loss_k, loss_p = losses[None], losses["plain"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    l2 = dist[None]
    if oracle:
        loss_n = losses["naive"]
        loss_bar = max(2e-2, 1.5 * abs(loss_n - loss_p) / abs(loss_p))
        bars = [max(GRAD_BAR, 1.5 * d) for d in dist["naive"]]
    else:
        loss_bar, bars = 2e-2, [GRAD_BAR] * len(l2)
    worst = max(range(len(l2)), key=lambda i: l2[i] / bars[i])
    print(f"{cfg.name} train step kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} "
          f"(rel {loss_rel:.3e}, bar {loss_bar:.3e}); gradient leaves: worst "
          f"relative L2 error against its bar {l2[worst]:.3e} (leaf {worst} "
          f"of {len(l2)}, {names[worst]}, bar {bars[worst]:.3e}), median "
          f"{sorted(l2)[len(l2) // 2]:.3e}, worst "
          f"relative max error {worst_max:.3e} [{card}]", flush=True)
    nearest = sorted(range(len(l2)), key=lambda i: -l2[i] / bars[i])[:5]
    if cfg.tied_embeddings:   # one leaf, the embedding's and the
        # unembedding's gradients summed
        i = names.index("/embed/table")
        print(f"{cfg.name} train step: the tied table {names[i]}, kernel vs "
              f"plain {l2[i]:.3e} (bar {bars[i]:.3e}) [{card}]", flush=True)
    if cfg.encdec is not None:   # the encoder's gradient comes through
        # every decoder block's cross-attention
        part = {what: max((i for i, n in enumerate(names) if key(n)),
                          key=lambda i: l2[i])
                for what, key in (("encoder", lambda n: n.startswith(
                    "/encoder/") or n.startswith("/ln_enc/")),
                                  ("cross-attention", lambda n: "/cross/" in n
                                   or "/ln_cross/" in n))}
        print(f"{cfg.name} train step: the five leaves nearest their bars "
              "(kernel vs plain, bar): " + ", ".join(
                  f"{names[i]} {l2[i]:.3e} / {bars[i]:.3e}" for i in nearest)
              + "; worst " + ", ".join(
                  f"{what} leaf {names[i]} {l2[i]:.3e}"
                  for what, i in part.items()) + f" [{card}]", flush=True)
    if oracle:
        print(f"{cfg.name} train step: naive oracle vs plain loss "
              f"{abs(loss_n - loss_p) / abs(loss_p):.3e}; the five leaves "
              "nearest their bars (kernel vs plain, bar): " + ", ".join(
                  f"{names[i]} {l2[i]:.3e} / {bars[i]:.3e}" for i in nearest)
              + "; tokens whose experts differ between the kernel's and the "
              f"plain step, by MoE layer (of {batch_size * PROMPT}): "
              f"{moved_tokens(picks[None], picks['plain'])} [{card}]",
              flush=True)
    if cfg.ssm is not None:
        fp32_distances(card, cfg, lm, params, batch, (loss_k, gk),
                       (loss_p, gp))
    if loss_rel > loss_bar or l2[worst] > bars[worst]:
        fail(f"a {cfg.name} training step through the kernels differs from "
             f"the plain twins: loss {loss_rel} (bar {loss_bar}), gradient "
             f"leaf {names[worst]} {l2[worst]} (bar {bars[worst]})")
    del params, leaves, gk, gp
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
                or fwd != counts(flash_attention=n)
                or trained != counts(flash_attention=2 * n,
                                     flash_attention_bwd=n,
                                     **optimizer_counts(state))):
            fail(f"reduced {cfg.name} through the kernels: rel {rel}, loss "
                 f"{loss}, launches {fwd} / {trained}")
        del model, state, step, logits, want


def cut_config(cfg, n: int):
    """`cfg` cut to its first n layers at every width; a hybrid config
    keeps its global-attention layers below n."""
    cut = dataclasses.replace(cfg, n_layers=n)
    if cfg.ssm is not None:
        cut = dataclasses.replace(cut, ssm=dataclasses.replace(
            cfg.ssm, global_attn_layers=tuple(
                i for i in cfg.ssm.global_attn_layers if i < n)))
    return cut


def serve_numbers(card, cfg, lm, fa) -> dict:
    """Phases 4b and 5 for a dense, MoE or hybrid model at full width:
    prefill logits through the kernel against the plain twin (relative max
    <= 2e-2; for a MoE or hybrid model the bar of `check_prefill_layers`,
    which also holds each layer's attention), prefill ms through each,
    decode ms /
    token, and the profiler's device-busy share of one prefill (with the
    flash forward's share, and a hybrid's scan's) and of a decode step.
    Returns the prefill ms and decode ms / token."""
    model = lm.build(cfg)
    plain = lm.build(cfg, force="plain")
    dev = torch.device("cuda")
    params = model.init(torch.Generator(dev).manual_seed(0))
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
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
        bar = check_prefill_layers(card, cfg, lm, params, prompts)
        if not (torch.isfinite(got).all().item() and rel <= bar):
            fail(f"{cfg.name} prefill logits through the kernel differ from "
                 f"plain: {rel} (bar {bar})")

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
              f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH}; "
              f"weights {weights_gb:.3f} GB [{card}]", flush=True)

        # 5. where the time goes: profiled device time against the above
        label = f"{cfg.name} prefill"
        rows = device_kernels(
            lambda: model.prefill(params, prompts, cache))
        report_busy(label, rows, prefill_ms, 1)
        for what, key in (("the flash forward", "flash_fwd"),
                          ("the selective-scan forward", "ssm_scan")):
            hit = [e for e in rows if key in e.key]
            if hit:
                hit_ms = sum(e.self_device_time_total for e in hit) / 1e3
                parts = "" if key != "ssm_scan" else " (" + ", ".join(
                    f"{re.search(r'ssm_scan_[a-z]+_kernel', e.key)[0]} "
                    f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                    for e in hit) + ")"
                print(f"{label}: {what} {hit_ms:.3f} ms of device time "
                      f"x{sum(e.count for e in hit)}{parts}, "
                      f"{100 * hit_ms / prefill_ms:.1f} % of the "
                      f"{prefill_ms:.3f} ms prefill [{card}]", flush=True)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + i)
        report_busy(f"{cfg.name} decode step", device_kernels(three_steps),
                    decode_ms, 3)
    del params, cache, got, want
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def check_prefill_layers(card, cfg, lm, params, prompts,
                         cross_ctx=None) -> float:
    """Phase 4 for a dense, MoE, hybrid or encoder-decoder model's prefill,
    kernel against plain twin.  Layer by layer on the same input (the
    kernel's own effect): each layer's attention (with its segment's
    window) through the kernel against the plain twin, relative max error
    <= 2e-2 (an encoder-decoder's decoder layers, given the encoder's
    output `cross_ctx`).
    Returns the bar of the logits: 2e-2 for a dense model; for a hybrid
    model that of `hybrid_logits_bar`.  In a MoE model an attention output
    that rounds to another bf16 value can move a router logit across a
    bf16 step, and a
    token whose top k changes takes another expert's output from there
    on; so its logits are held to max(2e-2, 1.5 x the plain twin's
    distance from the naive oracle, which rounds the attention
    probabilities to bf16 as the kernel does), and the tokens whose
    chosen experts differ between the kernel's prefill and the plain
    twin's are counted by layer."""
    from repro_torch.models import layers
    dev = prompts.device
    pos = torch.arange(PROMPT, device=dev)[None]
    x = layers.embed(params["embed"], prompts)
    worst = 0.0
    for i, seg in enumerate(lm.layer_plan(cfg)):
        for lp in params[f"seg{i}"]:
            h = layers.rmsnorm(lp["ln_attn"], x)
            outs = [layers.attention(lp["attn"],
                                     lm.attn_dims(cfg, seg.window), h, pos,
                                     force=force)
                    for force in (None, "plain")]
            worst = max(worst, rel_err(*outs))
            x, _ = lm._apply_block(lp, cfg, seg, x, pos, cross_ctx=cross_ctx)
    del x, h, outs
    print(f"{cfg.name} prefill: worst attention kernel vs plain on the same "
          f"input, over {cfg.n_layers} layers, {worst:.3e} (bar 2e-2) "
          f"[{card}]", flush=True)
    if worst > 2e-2:
        fail(f"{cfg.name}: an attention through the kernel differs from "
             f"plain: {worst}")
    if cfg.ssm is not None:
        return hybrid_logits_bar(card, cfg, lm, params, prompts)
    if cfg.moe is None:
        return 2e-2
    picks = {}

    def prefill(force):
        model = lm.build(cfg, force=force)
        with routing_picks(picks.setdefault(force, [])):
            return model.prefill(params, prompts,
                                 model.init_cache(BATCH, PROMPT, dev))
    got, want, naive = (prefill(f) for f in (None, "plain", "naive"))
    rel, floor = rel_err(got, want), rel_err(naive, want)
    bar = max(2e-2, 1.5 * floor)
    moved = moved_tokens(picks[None], picks["plain"])
    print(f"{cfg.name} prefill: logits kernel vs plain {rel:.3e} (bar "
          f"{bar:.3e}); naive oracle vs plain {floor:.3e}; kernel vs naive "
          f"{rel_err(got, naive):.3e}; tokens whose experts differ between "
          f"the kernel's and the plain twin's prefill, by MoE layer (of "
          f"{BATCH * PROMPT}): {moved} [{card}]", flush=True)
    return bar


def hybrid_logits_bar(card, cfg, lm, params, prompts) -> float:
    """The bar of a hybrid (Hymba) model's prefill logits, kernel against
    plain twin.  Each block adds rmsnorm(attention) + rmsnorm(SSM): the
    norm scales a layer's bf16 rounding of a small attention output up to
    unit RMS, so the residual streams of any two bf16 paths drift ~5e-2
    apart within a few layers (measured on the H100 at Hymba-1.5B's full
    width: the plain twin's own logits 4.7e-2 from fp32 activations, the
    kernel's 2.8e-2).  So the logits are held, as a MoE model's, to
    max(2e-2, 1.5 x the naive oracle's distance from the plain twin), and
    the kernel's to max(2e-2, 1.5 x the plain twin's distance) from a
    prefill in fp32 activations (the plain twins, the same weights and
    embedding): the kernel's path no farther from it than the twin's."""
    from repro_torch.models import layers
    dev = prompts.device

    def prefill(force):
        model = lm.build(cfg, force=force)
        return model.prefill(params, prompts,
                             model.init_cache(BATCH, PROMPT, dev))
    got, want, naive = (prefill(f) for f in (None, "plain", "naive"))
    pos = torch.arange(PROMPT, device=dev)[None]
    scale = cfg.d_model ** 0.5 if cfg.embed_scale_by_dim else 1.0
    x = layers.embed(params["embed"], prompts, scale).float()
    for i, seg in enumerate(lm.layer_plan(cfg)):
        for lp in params[f"seg{i}"]:
            x, _ = lm._apply_block(lp, cfg, seg, x, pos, force="plain")
    fp32 = layers.unembed(params["embed"],
                          layers.rmsnorm(params["ln_f"], x[:, -1:]),
                          cap=cfg.logit_cap or None)
    del x
    rel, floor = rel_err(got, want), rel_err(naive, want)
    bar = max(2e-2, 1.5 * floor)
    to_fp32, plain_fp32 = rel_err(got, fp32), rel_err(want, fp32)
    fp32_bar = max(2e-2, 1.5 * plain_fp32)
    print(f"{cfg.name} prefill: logits kernel vs plain {rel:.3e} (bar "
          f"{bar:.3e}); naive oracle vs plain {floor:.3e}; from fp32 "
          f"activations: kernel {to_fp32:.3e} (bar {fp32_bar:.3e}), plain "
          f"{plain_fp32:.3e}, naive {rel_err(naive, fp32):.3e} [{card}]",
          flush=True)
    if not to_fp32 <= fp32_bar:
        fail(f"{cfg.name}: the kernel's prefill logits are {to_fp32} from "
             f"fp32 activations, the plain twin's {plain_fp32}")
    return bar


def dense_serve(card, configs, serve, counters, arch) -> dict:
    """Phase 3 for a dense, MoE or hybrid model: `serve.main` at full width
    with every count set to 0 just before and read just after (one flash
    forward per layer; a hybrid's scan once per layer and call; nothing
    else; tokens in range).  Returns the serve's launches."""
    cfg = configs.get(arch)
    toks, launched, serve_s = serve_counted(serve, arch, counters)
    print(f"serve {arch}: {serve_s:.3f}s end to end (weights init included), "
          f"launches {launched} [{card}]", flush=True)
    # a hybrid also runs the scan once per layer and call: the prefill and
    # each of the GEN - 1 decode steps
    want = counts(flash_attention=cfg.n_layers, **(
        {"selective_scan": cfg.n_layers * GEN} if cfg.ssm is not None
        else {}))
    if launched != want:
        fail(f"serve {arch} launched {launched}; want {want} "
             f"(flash_attention once per layer ({cfg.n_layers}), a hybrid's "
             "scan once per layer and call, nothing else)")
    check_tokens(toks, cfg.vocab, arch)
    del toks
    return launched


def reduced_on_gpu(card, configs, lm, arch) -> None:
    """Phase 4c: `arch`'s reduced config, 2 x 64 tokens (below the flash
    threshold: its non-kernel layers; an encoder-decoder given seeded bf16
    frames), forward on the GPU against the CPU from the same params
    (relative max <= 2e-2)."""
    small = configs.get(arch, reduced=True)
    sm = lm.build(small)
    sp = sm.init(torch.Generator("cpu").manual_seed(0))
    stoks = torch.randint(0, small.vocab, (2, 64),
                          generator=torch.Generator("cpu").manual_seed(2))
    frames = (whisper_frames(small, 2, device="cpu")
              if small.encdec is not None else None)

    def kw(dev):
        return {} if frames is None else {"frames": frames.to(dev)}
    cpu_logits = sm.forward(sp, stoks, **kw("cpu"))
    sp_gpu = tree_map(lambda t: t.to("cuda"), sp)
    gpu_logits = sm.forward(sp_gpu, stoks.to("cuda"), **kw("cuda")).cpu()
    rel_small = ((gpu_logits - cpu_logits).abs().max()
                 / cpu_logits.abs().max()).item()
    print(f"reduced {small.name} forward, GPU vs CPU: rel max err "
          f"{rel_small:.3e}", flush=True)
    if rel_small > 2e-2:
        fail(f"reduced {small.name} forward on the GPU differs from the CPU:"
             f" {rel_small}")
    del sp, sp_gpu, cpu_logits, gpu_logits
    torch.cuda.empty_cache()


def moe_block_check(card, configs, lm) -> int:
    """Phase 5b: one `blocks.moe` call at DeepSeek-MoE 16B's full width (d
    2048, 64 experts, top 6, 2 shared, groups of 512, capacity factor 1.25:
    61 slots), fp32 activations, on the 4 x 2048 tokens of its prefill,
    on the card and on the CPU from the same numpy-seeded inputs (params,
    a router bias, x): the chosen experts and the kept (token, slot) pairs
    equal, the output within MOE_BLOCK_REL, the aux within MOE_AUX_ABS;
    the dropped slots counted (> 0: the drop path ran on the card).  Times
    the card's call in fp32 and in bf16.  Returns the dropped count."""
    import numpy as np
    from repro_torch.models import blocks
    dims = lm.moe_dims(configs.get(MOE_ARCH))
    rng = np.random.default_rng(0)
    params = blocks.init_moe(torch.Generator("cpu").manual_seed(0), dims,
                             dtype=torch.float32)
    params["router_bias"] = torch.from_numpy(
        1e-3 * rng.standard_normal(dims.n_experts).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, PROMPT, dims.d_model)).astype(np.float32))
    gp = tree_map(lambda t: t.to("cuda"), params)
    t = BATCH * PROMPT
    xg, valid = blocks.group_tokens(x, dims.group_size)
    want, want_aux = blocks.moe(params, dims, x)
    w_route = blocks.route(params, dims, xg, valid)
    with torch.no_grad():
        got, aux = blocks.moe(gp, dims, x.cuda())
        g_route = blocks.route(gp, dims, xg.cuda(), valid.cuda())
    same_experts = torch.equal(g_route[1].cpu(), w_route[1])
    same_kept = torch.equal(g_route[4].cpu(), w_route[4])
    dropped = int((valid[..., None] & ~w_route[4]).sum())
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    aux_err = abs(aux.item() - want_aux.item())
    xc = x.cuda()
    with torch.no_grad():
        f32_ms = time_ms(lambda: blocks.moe(gp, dims, xc), 3, warmup=1)
        gb = tree_map(lambda t: t.to(torch.bfloat16)
                      if t.dim() > 1 else t, gp)
        xb = xc.bfloat16()
        bf16_ms = time_ms(lambda: blocks.moe(gb, dims, xb), 3, warmup=1)
    print(f"{MOE_ARCH} MoE block at full width (d {dims.d_model}, "
          f"{dims.n_experts} experts, top {dims.top_k}, {dims.n_shared} "
          f"shared, group {dims.group_size}, capacity {dims.capacity}), fp32, "
          f"{t} tokens, card vs CPU: experts equal {same_experts}, kept "
          f"slots equal {same_kept}, {dropped} of {t * dims.top_k} slots "
          f"dropped; output rel max err {rel:.3e} (bar {MOE_BLOCK_REL}), aux "
          f"{aux.item():.7f} vs {want_aux.item():.7f} (err {aux_err:.3e}, "
          f"bar {MOE_AUX_ABS}); the card's call {f32_ms:.3f} ms fp32, "
          f"{bf16_ms:.3f} ms bf16 [{card}]", flush=True)
    if not (same_experts and same_kept and dropped > 0
            and rel <= MOE_BLOCK_REL and aux_err <= MOE_AUX_ABS):
        fail(f"the full-width MoE block on the card differs from the CPU: "
             f"experts {same_experts}, kept {same_kept}, dropped {dropped}, "
             f"rel {rel}, aux {aux_err}")
    del params, gp, gb, x, xc, xb, got, want
    torch.cuda.empty_cache()
    return dropped


def full_depth_serve(card, configs, lm, serve, fa, counters, arch) -> dict:
    """Phases 3-5 for a model served at every published width and full
    depth: with the card's memory released before it, `serve.main`
    counted (one flash forward per layer, nothing else), then
    `serve_numbers`; the peak memory of both
    (`torch.cuda.max_memory_allocated` after a reset)."""
    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    print(f"serve {arch}: {cfg.n_layers} layers (full depth), d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}; {held_gb:.3f} GB allocated before it", flush=True)
    launched = dense_serve(card, configs, serve, counters, arch)
    times = serve_numbers(card, cfg, lm, fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve {arch}: peak memory {peak_gb:.3f} GB (the serve and the "
          f"prefill / decode timings) [{card}]", flush=True)
    torch.cuda.empty_cache()
    scan = ({"scan_launches": launched["selective_scan"]}
            if cfg.ssm is not None else {})
    return {"launches": launched["flash_attention"], **scan,
            "peak_gb": peak_gb, **times}


def moe_train_step(card, configs, train) -> None:
    """Phase 5b: one `build_trainer` step of the reduced DeepSeek-MoE on
    the card (batch 2 x 64): a finite loss, and every router bias bitwise
    where it was (it enters only the top-k sort, so its gradient is zero,
    as under `jax.value_and_grad`)."""
    cfg = configs.get(MOE_ARCH, reduced=True)
    _, state, step, _ = train.build_trainer(cfg, device="cuda")
    before = [b.detach().clone() for b in router_biases(state.params)]
    state, m = step(state, train_batches(cfg, 1, 2, 64)[0])
    loss = float(m["loss"])
    same = [torch.equal(a, b) for a, b in
            zip(router_biases(state.params), before)]
    print(f"train reduced {MOE_ARCH} one step on the card: loss {loss:.4f}, "
          f"router biases unchanged {same} [{card}]", flush=True)
    if not (before and all(same) and math.isfinite(loss)):
        fail(f"reduced {MOE_ARCH} train step: loss {loss}, router biases "
             f"unchanged {same}")
    del state, step


def router_biases(params) -> list:
    """Every MoE layer's router bias."""
    return [lp["ffn"]["router_bias"] for name, sub in params.items()
            if name.startswith("seg") for lp in sub
            if "router_bias" in lp.get("ffn", {})]


def moe_train(card, configs, lm, train, counters) -> dict:
    """Phases 3-5 for DeepSeek-MoE 16B training (5b, after the reduced
    step): `train_path` at every published width and MOE_TRAIN_LAYERS deep
    (batch 4 x 2048, fp32 masters, AdamW, remat full: exactly 2 flash
    forwards and 1 flash backward a layer a step, every router bias
    bitwise unchanged), then its step through the kernels against the
    plain twins at MOE_CHECK_LAYERS, held by the naive oracle
    (`train_vs_plain`).  Returns `train_path`'s numbers."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    full = configs.get(MOE_ARCH)
    cfg = cut_config(full, MOE_TRAIN_LAYERS)
    print(f"train {MOE_ARCH}: every published width, depth cut to "
          f"{MOE_TRAIN_LAYERS} of {full.n_layers} layers "
          f"({[(g.kind, g.count) for g in lm.layer_plan(cfg)]}; fp32 masters "
          "with grads, m and v ~36 GB; all 28 layers need ~262 GB)",
          flush=True)
    trained = train_path(card, cfg, BATCH, train, counters,
                         fixed=router_biases)
    train_vs_plain(card, cut_config(full, MOE_CHECK_LAYERS), BATCH, lm)
    print(f"moe training phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return trained


def v3_mla_check(card, configs, lm, fa) -> dict:
    """Phase 5b: one fp32 `blocks.mla_attention` call at DeepSeek-V3's full
    width, batch 1 x PROMPT into a fp32 latent cache of PROMPT + 1
    positions, then one decode step, on the card (the prefill through the
    MLA-layout kernel: one launch) and on the CPU (its plain twin) from the
    same numpy-seeded params and inputs: both outputs and the cache
    entries within V3_MLA_REL (relative max)."""
    import numpy as np
    from repro_torch.models import blocks
    t0 = time.perf_counter()
    dims = lm.mla_dims(configs.get(V3_ARCH))
    rng = np.random.default_rng(0)
    d, h, r_q, r_kv = (dims.d_model, dims.n_heads, dims.q_lora_rank,
                       dims.kv_lora_rank)
    # `blocks.init_mla`'s leaves: (shape, fan-in)
    leaves = {"wq_a": ((d, r_q), d), "wq_b": ((r_q, h, dims.qk_dim), r_q),
              "wkv_a": ((d, r_kv + dims.qk_rope_dim), d),
              "wk_b": ((r_kv, h, dims.qk_nope_dim), r_kv),
              "wv_b": ((r_kv, h, dims.v_head_dim), r_kv),
              "wo": ((h, dims.v_head_dim, d), h * dims.v_head_dim)}
    cpu_p = {name: torch.from_numpy(
        (rng.standard_normal(shape) * n ** -0.5).astype(np.float32))
        for name, (shape, n) in leaves.items()}
    for name, n in (("q_norm", r_q), ("kv_norm", r_kv)):
        cpu_p[name] = {"scale": torch.from_numpy(
            (1 + 0.1 * rng.standard_normal(n)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal(
        (1, PROMPT + 1, dims.d_model)).astype(np.float32))

    def run(dev):
        p = tree_map(lambda t: t.to(dev), cpu_p)
        cache = blocks.init_mla_cache(1, PROMPT + 1, dims, dev,
                                      dtype=torch.float32)
        xt, pos = x.to(dev), torch.arange(PROMPT + 1, device=dev)[None]
        with torch.no_grad():
            pre = blocks.mla_attention(p, dims, xt[:, :PROMPT],
                                       pos[:, :PROMPT], kv_cache=cache,
                                       cache_index=0)
            dec = blocks.mla_attention(p, dims, xt[:, PROMPT:],
                                       pos[:, PROMPT:], kv_cache=cache,
                                       cache_index=PROMPT)
        return [t.cpu() for t in (pre, dec, cache["ckv"], cache["krope"])]
    before = fa.flash_attention.launches_mla
    got = run("cuda")
    launched = fa.flash_attention.launches_mla - before
    want = run("cpu")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    print(f"{V3_ARCH} MLA block at full width (d {dims.d_model}, "
          f"{dims.n_heads} heads, q rank {dims.q_lora_rank}, kv rank "
          f"{dims.kv_lora_rank}, rope {dims.qk_rope_dim}), fp32, 1 x "
          f"{PROMPT} then one decode step, card vs CPU: relative max errors "
          f"prefill {errs[0]:.3e}, decode {errs[1]:.3e}, cache ckv "
          f"{errs[2]:.3e}, krope {errs[3]:.3e} (bar {V3_MLA_REL}); "
          f"{launched} MLA-layout launches on the card; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if launched != 1 or max(errs) > V3_MLA_REL:
        fail(f"the full-width fp32 MLA block on the card differs from the "
             f"CPU: {errs}, launches {launched}")
    del got, want, cpu_p
    return {"rel_errs": errs}


def v3_serve(card, configs, lm, serve, counters) -> dict:
    """Phases 3-5 for DeepSeek-V3 at every published width and
    V3_SERVE_LAYERS deep (5b, last of its models, the card's memory
    released before it): `serve.generate` counted (exactly one MLA-layout
    flash forward a layer for the prefill, none in decode, nothing else);
    each layer's MLA on the same input through the kernel against the
    plain twin (relative max <= 2e-2); the prefill logits against the plain
    twin within max(2e-2, 1.5 x the naive oracle's distance), the tokens
    whose experts differ counted by MoE layer; these checks one sequence at
    a time (the oracle's fp32 logits at 128 heads are 8.7 GB a layer at
    batch 4); prefill ms, decode ms / token, the profiler's device time of
    one prefill with the MLA kernel's share, the weights' bytes and peak
    memory."""
    from repro_torch.models import blocks, layers
    t_phase = time.perf_counter()
    full = configs.get(V3_ARCH)
    cfg = dataclasses.replace(full, n_layers=V3_SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    model = lm.build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
    n_params = sum(t.numel() for t in tree_leaves(params)) / 1e9
    print(f"serve {V3_ARCH}: every published width, depth cut to "
          f"{V3_SERVE_LAYERS} of {full.n_layers} layers "
          f"({[(g.kind, g.count) for g in model.plan]}), {n_params:.3f} B "
          f"params, {weights_gb:.3f} GB of weights (the MTP head's "
          f"included), initialised in {init_s:.1f} s", flush=True)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    set_counts(counters)
    t0 = time.perf_counter()
    toks = serve.generate(model, params, prompts, PROMPT + GEN, GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched = read_counts(counters)
    print(f"serve {V3_ARCH}: {serve_s:.3f}s end to end (batch {BATCH}, "
          f"prompt {PROMPT}, {GEN} new tokens), launches {launched} "
          f"[{card}]", flush=True)
    if launched != counts(flash_attention_mla=cfg.n_layers):
        fail(f"serve {V3_ARCH} launched {launched}; want "
             f"{counts(flash_attention_mla=cfg.n_layers)} (the flash forward "
             "at the MLA layout once per layer, nothing else)")
    check_tokens(toks, cfg.vocab, V3_ARCH)
    dims = lm.mla_dims(cfg)
    pos = torch.arange(PROMPT, device=dev)[None]
    scale = cfg.d_model ** 0.5 if cfg.embed_scale_by_dim else 1.0
    with torch.inference_mode():
        worst = 0.0
        for i in range(BATCH):
            x = layers.embed(params["embed"], prompts[i:i + 1], scale)
            for j, seg in enumerate(model.plan):
                for lp in params[f"seg{j}"]:
                    h = layers.rmsnorm(lp["ln_attn"], x)
                    outs = [blocks.mla_attention(lp["attn"], dims, h, pos,
                                                 force=force)
                            for force in (None, "plain")]
                    worst = max(worst, rel_err(*outs))
                    x, _ = lm._apply_block(lp, cfg, seg, x, pos)
            del x, h, outs
        print(f"{V3_ARCH} prefill: worst MLA kernel vs plain on the same "
              f"input, over {cfg.n_layers} layers and {BATCH} sequences, "
              f"{worst:.3e} (bar 2e-2) [{card}]", flush=True)
        if worst > 2e-2:
            fail(f"{V3_ARCH}: an MLA through the kernel differs from plain: "
                 f"{worst}")
        picks, logits = {}, {}
        for force in (None, "plain", "naive"):
            m = lm.build(cfg, force=force)
            rows = []
            for i in range(BATCH):
                with routing_picks(picks.setdefault(force, [])):
                    rows.append(m.prefill(params, prompts[i:i + 1],
                                          m.init_cache(1, PROMPT, dev)))
                torch.cuda.empty_cache()
            logits[force] = torch.cat(rows)
        got, want, naive = logits[None], logits["plain"], logits["naive"]
        rel, floor = rel_err(got, want), rel_err(naive, want)
        bar = max(2e-2, 1.5 * floor)
        n_moe = sum(g.count for g in model.plan if g.kind == "moe")
        per = moved_tokens(picks[None], picks["plain"])   # sequence-major
        moved = [sum(per[j::n_moe]) for j in range(n_moe)]
        print(f"{V3_ARCH} prefill: logits kernel vs plain {rel:.3e} (bar "
              f"{bar:.3e}); naive oracle vs plain {floor:.3e}; kernel vs "
              f"naive {rel_err(got, naive):.3e}; tokens whose experts differ "
              f"between the kernel's and the plain twin's prefill, by MoE "
              f"layer (of {BATCH * PROMPT}): {moved} [{card}]", flush=True)
        if not (torch.isfinite(got).all().item() and rel <= bar):
            fail(f"{V3_ARCH} prefill logits through the kernel differ from "
                 f"plain: {rel} (bar {bar})")
        del logits, got, want, naive, picks
        torch.cuda.empty_cache()

        cache = model.init_cache(BATCH, PROMPT + GEN, dev)
        prefill_ms = time_ms(lambda: model.prefill(params, prompts, cache), 3,
                             warmup=1)
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
        print(f"{V3_ARCH} prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms; "
              f"decode {decode_ms:.3f} ms/token, "
              f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH}; "
              f"weights {weights_gb:.3f} GB [{card}]", flush=True)
        label = f"{V3_ARCH} prefill"
        rows = device_kernels(lambda: model.prefill(params, prompts, cache))
        report_busy(label, rows, prefill_ms, 1)
        hit = [e for e in rows if "flash_fwd_mla" in e.key]
        mla_ms = (sum(e.self_device_time_total for e in hit) / 1e3
                  if hit else None)
        if hit:
            print(f"{label}: the flash forward at the MLA layout "
                  f"{mla_ms:.3f} ms of device time "
                  f"x{sum(e.count for e in hit)}, "
                  f"{100 * mla_ms / prefill_ms:.1f} % of the "
                  f"{prefill_ms:.3f} ms prefill [{card}]", flush=True)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + i)
        report_busy(f"{V3_ARCH} decode step", device_kernels(three_steps),
                    decode_ms, 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve {V3_ARCH}: peak memory {peak_gb:.3f} GB; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del params, cache, toks, model
    torch.cuda.empty_cache()
    return {"launches": launched["flash_attention_mla"], "peak_gb": peak_gb,
            "weights_gb": weights_gb, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "mla_device_ms": mla_ms,
            "logits_rel": rel, "logits_bar": bar, "moved_tokens": moved}


def v3_train(card, configs, lm, train, counters) -> dict:
    """Phases 3-5 for DeepSeek-V3 training (5b, after its serve, the card's
    memory released): `train_path` at every published width, cut as
    V3_TRAIN_LAYERS / V3_TRAIN_EXPERTS say (batch 1 x 2048, fp32 masters,
    AdamW, remat full, the MTP loss: exactly 2 MLA-layout flash forwards a
    trunk layer and 1 for the MTP block, and 1 MLA-layout backward a MLA
    block, a step, nothing else; every router bias bitwise unchanged),
    then its step through the kernels against the plain twins at the same
    cut, held by the naive oracle (`train_vs_plain`).  Returns
    `train_path`'s numbers."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    full = configs.get(V3_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=V3_TRAIN_LAYERS, moe=dataclasses.replace(
            full.moe, first_dense_layers=1, n_experts=V3_TRAIN_EXPERTS))
    print(f"train {V3_ARCH}: every published width, depth cut to "
          f"{V3_TRAIN_LAYERS} of {full.n_layers} layers "
          f"({[(g.kind, g.count) for g in lm.layer_plan(cfg)]}) and the "
          f"routed experts to {V3_TRAIN_EXPERTS} of {full.moe.n_experts}, "
          f"the MTP head included; batch {V3_TRAIN_BATCH} x {PROMPT}",
          flush=True)
    trained = train_path(card, cfg, V3_TRAIN_BATCH, train, counters,
                         fixed=router_biases)
    train_vs_plain(card, cfg, V3_TRAIN_BATCH, lm)
    print(f"{V3_ARCH} training phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return trained


def bf16_state_close(got, want) -> tuple:
    """A bf16 state from fp32 work on two devices: (share of elements
    equal, max |got - want| in bf16 ulps at |want|, max |got - want| /
    max |want|, ok).  ok: every element within one bf16 ulp of its value
    plus SSM_BLOCK_REL x max |want|, the fp32 parity the block's output is
    held to (a value near 0 from cancellation carries the fp32 work's
    error, which one ulp at that value does not cover)."""
    got, want = got.float().cpu(), want.float().cpu()
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                         - 7)
    diff = (got - want).abs()
    top = want.abs().max()
    ok = bool((diff <= spacing + SSM_BLOCK_REL * top).all())
    return ((diff == 0).float().mean().item(), (diff / spacing).max().item(),
            (diff.max() / top.clamp_min(1e-30)).item(), ok)


def ssm_block_check(card, configs, lm) -> dict:
    """Phase 5c: one `blocks.ssm` call at Hymba-1.5B's full width (d_model
    = d_inner 1600, state 16, conv 4, dt rank 100), fp32 activations, on
    the 4 x 2048 tokens of its prefill, on the card and on the CPU from the
    same numpy-seeded params and input: the output within SSM_BLOCK_REL
    (relative max), the new bf16 state (conv tail and h) within one bf16
    ulp plus that parity (`bf16_state_close`); then one decode step from
    the CPU's state, card against CPU, likewise.  Times the card's call in fp32 and in bf16 (bf16 weights, as
    served) and counts its device launches (profiler).  Returns the
    numbers for the report."""
    import numpy as np
    from repro_torch.models import blocks
    dims = lm.ssm_dims(configs.get(HYMBA_ARCH))
    rng = np.random.default_rng(0)
    params = blocks.init_ssm(torch.Generator("cpu").manual_seed(0), dims,
                             dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, PROMPT + 1, dims.d_model)).astype(np.float32))
    gp = tree_map(lambda t: t.to("cuda"), params)
    xc = x[:, :PROMPT].cuda()
    with torch.no_grad():
        want, w_state = blocks.ssm(params, dims, x[:, :PROMPT])
        got, g_state = blocks.ssm(gp, dims, xc)
        want1, w_state1 = blocks.ssm(params, dims, x[:, PROMPT:],
                                     state=w_state)
        got1, g_state1 = blocks.ssm(gp, dims, x[:, PROMPT:].cuda(),
                                    state=tree_map(lambda t: t.cuda(),
                                                   w_state))
    rel = (rel_err(got.cpu(), want), rel_err(got1.cpu(), want1))
    states = {f"{k}{after}": bf16_state_close(g[k], w[k])
              for after, g, w in (("", g_state, w_state),
                                  (" after the step", g_state1, w_state1))
              for k in ("conv", "h")}
    with torch.no_grad():
        f32_ms = time_ms(lambda: blocks.ssm(gp, dims, xc), 3, warmup=1)
        gb = {k: t if k == "a_log" else t.bfloat16() for k, t in gp.items()}
        xb = xc.bfloat16()
        bf16_ms = time_ms(lambda: blocks.ssm(gb, dims, xb), 3, warmup=1)
        rows = device_kernels(lambda: blocks.ssm(gb, dims, xb))
    launches = sum(e.count for e in rows)
    print(f"{HYMBA_ARCH} SSM block at full width (d_inner {dims.d_inner}, "
          f"state {dims.state_dim}, conv {dims.conv_k}, dt rank {dims.dtr}), "
          f"fp32, {BATCH} x {PROMPT} tokens, card vs CPU: output rel max err "
          f"{rel[0]:.3e}, one decode step {rel[1]:.3e} (bar {SSM_BLOCK_REL});"
          f" the bf16 state (share equal, max bf16 ulps at the value, rel "
          f"max err, within one ulp + {SSM_BLOCK_REL} x max): " + "; ".join(
              f"{k} {e:.4f}, {u:.0f}, {r:.3e}, {ok}"
              for k, (e, u, r, ok) in states.items()) + f"; the card's call "
          f"{f32_ms:.3f} ms fp32, {bf16_ms:.3f} ms bf16, {launches} device "
          f"launches a bf16 call [{card}]", flush=True)
    report_busy(f"{HYMBA_ARCH} SSM block bf16", rows, bf16_ms, 1)
    if max(rel) > SSM_BLOCK_REL or not all(v[3] for v in states.values()):
        fail(f"the full-width SSM block on the card differs from the CPU: "
             f"rel {rel}, states {states}")
    del params, gp, gb, x, xc, xb, got, want
    torch.cuda.empty_cache()
    return {"rel_max_err": rel[0], "f32_ms": f32_ms, "bf16_ms": bf16_ms,
            "launches": launches}


def hymba_phase(card, configs, lm, serve, fa, counters) -> tuple:
    """Phases 3-5 for Hymba-1.5B, after every other model (5c): the SSM
    block at full width card against CPU, the reduced model on the GPU
    against the CPU (2 x 64 tokens cross its 16-token window), the flash
    forward timed at its windowed and global prefill shapes, then the
    model served at every published width and full depth
    (`full_depth_serve`: exactly 32 flash forwards a serve, 29 of them
    windowed).  Returns (the serve's numbers, the windowed shape's
    timings, the SSM block's numbers)."""
    torch.cuda.empty_cache()
    ssm = ssm_block_check(card, configs, lm)
    reduced_on_gpu(card, configs, lm, HYMBA_ARCH)
    windowed = time_flash(fa, HYMBA_WINDOW, card)
    time_flash(fa, HYMBA_GLOBAL, card)
    served = full_depth_serve(card, configs, lm, serve, fa, counters,
                              HYMBA_ARCH)
    return served, windowed, ssm


def hymba_train(card, configs, lm, train, fa, ss, ref, counters) -> tuple:
    """Phases 3-5 for Hymba-1.5B training (5c, after its serve):
    `train_path` at every published width and full depth (batch 4 x 2048,
    fp32 masters, remat full: exactly 2 flash forwards, 1 flash backward,
    2 scan forwards and 1 scan backward a layer a step), the step through
    the kernels against the plain twins at HYMBA_CHECK_LAYERS layers, the
    flash backward at the windowed shape beside SDPA's, and the scan
    kernels timed at SCAN_MAIN.  Returns (the step's launches, the window
    backward's timings, the scan's timings)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = configs.get(HYMBA_ARCH)
    trained = train_path(card, cfg, BATCH, train, counters)
    cut = cut_config(cfg, HYMBA_CHECK_LAYERS)
    print(f"train {HYMBA_ARCH} kernels vs plain: every published width, "
          f"depth cut to {HYMBA_CHECK_LAYERS} of {cfg.n_layers} layers "
          f"({[(g.kind, g.count, g.window) for g in lm.layer_plan(cut)]}; "
          "the plain scan's autograd graph saves h for every token, ~0.84 "
          "GB a layer)", flush=True)
    train_vs_plain(card, cut, BATCH, lm)
    window_bwd = time_flash_bwd(fa, ref, HYMBA_WINDOW, card)
    scan = time_scan(ss, ref, card)
    torch.cuda.empty_cache()
    print(f"hymba training phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return trained["launches"], window_bwd, scan


def whisper_serve(card, configs, lm, serve, counters) -> dict:
    """Phases 3-5 for Whisper-small (5d, after Hymba-1.5B's training, the
    card's memory released): the reduced model on the GPU against the CPU
    (given frames); `serve.main` counted at prompt PROMPT (exactly one
    flash forward a decoder layer, nothing in the encoder, the
    cross-attention or decode) and at the published decoder context
    (WHISPER_CONTEXT tokens in all: no launch at all); then with seeded
    random frames: `serve.generate` counted likewise, the encoder's output
    on the card against the CPU (one sequence in fp32, WHISPER_ENC_REL; the
    encoder launches nothing), the prefill logits given the encoder's
    output through the kernel against the plain twin (<= 2e-2) and each
    decoder layer's self-attention on the same input (`check_prefill_layers`),
    encode ms, prefill ms, decode ms / token, the profiler's busy shares
    of an encode, a prefill (with the flash forward's share) and a decode
    step, and the peak memory.  Returns the numbers for the `served`
    line."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(WHISPER_ARCH)
    reduced_on_gpu(card, configs, lm, WHISPER_ARCH)
    print(f"serve {WHISPER_ARCH}: {cfg.encdec.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers (full depth), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, "
          f"{cfg.encdec.n_frames} frames; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before "
          "it", flush=True)
    launched = dense_serve(card, configs, serve, counters, WHISPER_ARCH)
    prompt = WHISPER_CONTEXT - GEN
    toks, short, serve_s = serve_counted(serve, WHISPER_ARCH, counters,
                                         prompt=prompt)
    print(f"serve {WHISPER_ARCH} at the published decoder context ({prompt} "
          f"+ {GEN} = {WHISPER_CONTEXT} tokens): {serve_s:.3f}s end to end, "
          f"launches {short} [{card}]", flush=True)
    if short != counts():
        fail(f"serve {WHISPER_ARCH} at {WHISPER_CONTEXT} tokens launched "
             f"{short}; want none (below FLASH_THRESHOLD)")
    check_tokens(toks, cfg.vocab, WHISPER_ARCH)

    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    dev = torch.device("cuda")
    params = model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params)) / 1e9
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
    frames = whisper_frames(cfg, BATCH)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    with torch.inference_mode():
        set_counts(counters)
        toks = serve.generate(model, params, prompts, PROMPT + GEN, GEN,
                              frames)
        gen_launches = read_counts(counters)
        check_tokens(toks, cfg.vocab, WHISPER_ARCH)
        set_counts(counters)
        enc = model.encode(params, frames)
        enc_launches = read_counts(counters)
        p32 = {k: tree_map(lambda t: t.float(), params[k])
               for k in ("encoder", "ln_enc")}
        f32 = frames[:1].float()
        enc_rel = rel_err(model.encode(p32, f32).cpu(), model.encode(
            tree_map(lambda t: t.cpu(), p32), f32.cpu()))
        del p32
        cache = model.init_cache(BATCH, PROMPT + GEN, dev)
        got = model.prefill(params, prompts, cache, enc_out=enc)
        want = plain.prefill(params, prompts,
                             plain.init_cache(BATCH, PROMPT + GEN, dev),
                             enc_out=enc)
        rel = rel_err(got, want)
        print(f"{WHISPER_ARCH} ({n_params:.4f} B params, weights "
              f"{weights_gb:.3f} GB): serve.generate with seeded frames, "
              f"launches {gen_launches}; encode launches {enc_launches}; "
              f"encoder output in fp32 card vs CPU (one sequence) rel max "
              f"err {enc_rel:.3e} (bar {WHISPER_ENC_REL}); prefill logits "
              "kernel vs plain rel "
              f"max err {rel:.3e} (bar 2e-2) [{card}]", flush=True)
        bar = check_prefill_layers(card, cfg, lm, params, prompts,
                                   cross_ctx=enc)
        if (gen_launches != counts(flash_attention=cfg.n_layers)
                or enc_launches != counts() or enc_rel > WHISPER_ENC_REL
                or not torch.isfinite(got).all().item() or rel > bar):
            fail(f"{WHISPER_ARCH}: generate launched {gen_launches}, encode "
                 f"{enc_launches}; encoder card vs CPU {enc_rel}; prefill "
                 f"logits kernel vs plain {rel} (bar {bar})")

        encode_ms = time_ms(lambda: model.encode(params, frames), 3,
                            warmup=1)
        prefill_ms = time_ms(
            lambda: model.prefill(params, prompts, cache, enc_out=enc), 3,
            warmup=1)
        plain_prefill_ms = time_ms(
            lambda: plain.prefill(params, prompts, cache, enc_out=enc), 2,
            warmup=1)
        tok = got[:, -1].argmax(dim=-1, keepdim=True)
        model.prefill(params, prompts, cache, enc_out=enc)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(GEN - 1):
            tok = model.decode_step(params, tok, cache, PROMPT + i,
                                    enc_out=enc)[:, -1].argmax(
                dim=-1, keepdim=True)
        end.record()
        end.synchronize()
        decode_ms = start.elapsed_time(end) / (GEN - 1)
        print(f"{WHISPER_ARCH} encode {BATCH}x{cfg.encdec.n_frames} frames "
              f"{encode_ms:.3f} ms; prefill {BATCH}x{PROMPT} given the "
              f"encoder's output {prefill_ms:.3f} ms through the kernel, "
              f"{plain_prefill_ms:.3f} ms through the plain twin; decode "
              f"{decode_ms:.3f} ms/token ({BATCH * 1e3 / decode_ms:.1f} "
              f"tokens/s at batch {BATCH}; each step recomputes the "
              f"cross-attention's K and V from the frames) [{card}]",
              flush=True)
        report_busy(f"{WHISPER_ARCH} encode",
                    device_kernels(lambda: model.encode(params, frames)),
                    encode_ms, 1)
        rows = device_kernels(
            lambda: model.prefill(params, prompts, cache, enc_out=enc))
        report_busy(f"{WHISPER_ARCH} prefill", rows, prefill_ms, 1, top=8)
        hit = [e for e in rows if "flash_fwd" in e.key]
        if hit:
            hit_ms = sum(e.self_device_time_total for e in hit) / 1e3
            print(f"{WHISPER_ARCH} prefill: the flash forward {hit_ms:.3f} ms "
                  f"of device time x{sum(e.count for e in hit)}, "
                  f"{100 * hit_ms / prefill_ms:.1f} % of the "
                  f"{prefill_ms:.3f} ms prefill [{card}]", flush=True)

        def three_steps():
            for i in range(3):
                model.decode_step(params, tok, cache, PROMPT + i, enc_out=enc)
        report_busy(f"{WHISPER_ARCH} decode step",
                    device_kernels(three_steps), decode_ms, 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve {WHISPER_ARCH}: peak memory {peak_gb:.3f} GB; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del params, cache, enc, got, want, frames
    torch.cuda.empty_cache()
    return {"launches": launched["flash_attention"],
            f"launches_at_{WHISPER_CONTEXT}": short["flash_attention"],
            "params_b": n_params, "encode_ms": encode_ms,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "encoder_rel_err": enc_rel, "logits_rel_err": rel,
            "peak_gb": peak_gb}


def whisper_train(card, configs, lm, train, counters) -> dict:
    """Phases 3-5 for Whisper-small training (5d, after its serve):
    `train_path` at every published width and full depth (batch 4 x 2048
    decoder tokens with seeded bf16 frames, fp32 masters, remat full:
    exactly 2 flash forwards and 1 flash backward a decoder layer a step,
    none in the encoder or the cross-attention), then its step through the
    kernels against the plain twins (`train_vs_plain`: the encoder's and
    the cross-attention's leaves among those held, the five nearest their
    bars printed).  Returns `train_path`'s numbers."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = configs.get(WHISPER_ARCH)
    trained = train_path(card, cfg, BATCH, train, counters)
    train_vs_plain(card, cfg, BATCH, lm)
    print(f"whisper training phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return trained


@contextlib.contextmanager
def recorded_lrs(train, lrs: list):
    """While open, the train steps that `train.build_trainer` builds append
    (step, LR) to `lrs` for every LR their schedule (`schedule_for(cfg)`)
    gives AdamW, and the schedule's function name is `lrs`' first entry."""
    real = train.schedule_for

    def schedule_for(cfg):
        fn = real(cfg)
        lrs.append(fn.func.__name__)

        def recorded(step):
            lr = fn(step)
            lrs.append((int(step), float(lr)))
            return lr
        return recorded
    train.schedule_for = schedule_for
    try:
        yield lrs
    finally:
        train.schedule_for = real


def dense_train(card, cfg, batch: int, lm, train, counters) -> dict:
    """Phases 3-5 for a dense model's training (5e): `train_path` (exactly
    2 flash forwards and 1 flash backward a layer a step) with the LR of
    every step recorded from its schedule and printed beside what the
    other archs' schedule would give (`schedule_for` picks WSD by the
    name "minicpm", cosine for every other name), then its step through
    the kernels against the plain twins (`train_vs_plain`).  Returns
    `train_path`'s numbers with the schedule's name and LRs."""
    from repro_torch.launch.specs import schedule_for
    lrs = []
    with recorded_lrs(train, lrs):
        trained = train_path(card, cfg, batch, train, counters)
    kind, steps = lrs[0], lrs[1:]
    other = schedule_for(dataclasses.replace(
        cfg, name="minicpm" if kind == "cosine" else "other"))
    print(f"train {cfg.name}: schedule_for gives {kind} "
          f"({schedule_for(cfg).keywords}); the LR AdamW took at steps "
          f"{[s for s, _ in steps]}: {[lr for _, lr in steps]} (the other "
          f"schedule, {other.func.__name__} {other.keywords}, would give "
          f"{[float(other(s)) for s, _ in steps]}) [{card}]", flush=True)
    if not steps or kind != ("wsd" if "minicpm" in cfg.name else "cosine"):
        fail(f"train {cfg.name}: the steps took their LR from {kind} "
             f"({steps})")
    train_vs_plain(card, cfg, batch, lm)
    return {**trained, "schedule": kind, "lrs": [lr for _, lr in steps]}


def adamw_phase(card, configs, lm, aw) -> dict:
    """Phase 5e's first part: AdamW's kernels at MiniCPM-2B's 362 fp32
    leaves (2,724,880,896 params; the decay mask of its param tree), fp32
    grads drawn with a norm far above the clip.  One step through the
    kernels against the plain loop run a leaf at a time with the plain
    norm's scale: p, m and v each within ADAMW_BAR of the loop's (max |got
    - want| over max |want|, a leaf), the norm within ADAMW_BAR of
    float64's.  Then, by CUDA events over repeated calls, the update with
    its clipping norm as `adamw_update` runs it, the norm alone (the
    metrics' second one), the plain loop and the plain norm beside the
    bytes bound (the update's 28 B and a norm's 4 B a param at
    PEAK_BYTES), and as `library_ms` `torch.optim.AdamW(fused=True)` after
    `clip_grad_norm_(foreach=True)` (a yardstick the port never calls);
    the kernels' device time by profiler and the host's time a call.
    Returns the numbers of the `kernels` line's two entries."""
    import numpy as np
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim import AdamWConfig, decay_mask
    torch.cuda.empty_cache()
    with FakeTensorMode():
        fake = lm.build(configs.get(MINICPM_ARCH)).init(
            None, torch.float32, device="cpu")
    shapes = [p.shape for p in tree_leaves(fake)]
    decay = decay_mask(fake)
    n = sum(s.numel() for s in shapes)
    gen = torch.Generator("cuda").manual_seed(0)
    ps = [0.02 * torch.randn(s, generator=gen, device="cuda") for s in shapes]
    gs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    ms = [torch.zeros(s, device="cuda") for s in shapes]
    vs = [torch.zeros(s, device="cuda") for s in shapes]
    cfg = AdamWConfig()
    # step 1's LR and bias corrections, as `optim.adamw_update` takes them
    setup = (1e-2, float(np.float32(1) - np.float32(cfg.b1)),
             float(np.float32(1) - np.float32(cfg.b2)))
    p0 = [p.clone() for p in ps]
    aw.adamw(ps, gs, ms, vs, decay, cfg, *setup)
    scale = torch.clamp(cfg.clip_norm / (aw.global_norm_plain(gs) + 1e-9),
                        max=1.0)
    err = 0.0
    for i in range(len(ps)):
        p, m, v = p0[i], torch.zeros_like(ms[i]), torch.zeros_like(vs[i])
        p0[i] = None
        aw.update_plain([p], [gs[i]], [m], [v], [decay[i]], scale, cfg,
                        *setup)
        err = max(err, rel_err(ps[i], p), rel_err(ms[i], m),
                  rel_err(vs[i], v))
        del p, m, v
    del p0
    norm64 = math.sqrt(sum(g.double().square().sum().item() for g in gs))
    norm_err = abs(aw.global_norm(gs).item() - norm64) / norm64
    print(f"adamw at {MINICPM_ARCH}'s {len(shapes)} leaves ({n} fp32 "
          f"params, {sum(decay)} decayed): one step, kernels vs the plain "
          f"loop rel max err {err:.3e} (p, m, v; bar {ADAMW_BAR}); norm "
          f"{norm64:.6e}, kernels' rel err {norm_err:.3e} against float64 "
          f"[{card}]", flush=True)
    if err > ADAMW_BAR or norm_err > ADAMW_BAR:
        fail(f"adamw kernels: rel err {err}, norm rel err {norm_err}")

    def step():
        aw.adamw(ps, gs, ms, vs, decay, cfg, *setup)

    def plain():
        aw.adamw_plain(ps, gs, ms, vs, decay, cfg, *setup)
    upd_bound, norm_bound = (b * n / PEAK_BYTES * 1e3 for b in (28, 4))
    got = {"ms": time_ms(step, 10), "norm_ms": time_ms(
        lambda: aw.global_norm(gs), 10), "host_ms": host_ms(step, 10)}
    rows = device_kernels(step)
    parts = {k: (sum(e.self_device_time_total for e in rows if k in e.key)
                 / 1e3, sum(e.count for e in rows if k in e.key))
             for k in ("norm_partial_kernel", "norm_final_kernel",
                       "adamw_kernel")}
    got["plain_ms"] = time_ms(plain, 3, warmup=1)
    got["plain_host_ms"] = host_ms(plain, 2)
    got["plain_norm_ms"] = time_ms(lambda: aw.global_norm_plain(gs), 3,
                                   warmup=1)
    del ms, vs
    torch.cuda.empty_cache()
    for p, g in zip(ps, gs):
        p.grad = g
    opt = torch.optim.AdamW(
        [{"params": [p for p, d in zip(ps, decay) if d]},
         {"params": [p for p, d in zip(ps, decay) if not d],
          "weight_decay": 0.0}],
        lr=setup[0], betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        weight_decay=cfg.weight_decay, fused=True)

    def library():
        torch.nn.utils.clip_grad_norm_(ps, cfg.clip_norm, foreach=True)
        opt.step()
    got["library_ms"] = time_ms(library, 10)
    got["library_step_ms"] = time_ms(opt.step, 10)
    got["library_norm_ms"] = time_ms(lambda: torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(gs))), 10)
    del opt, ps, gs
    torch.cuda.empty_cache()
    bound = upd_bound + norm_bound
    print(f"adamw at {MINICPM_ARCH}'s leaves: update with its clip norm "
          f"{got['ms']:.3f} ms ({got['ms'] / bound:.3f} x the bytes bound "
          f"{bound:.3f} = {upd_bound:.3f} + {norm_bound:.3f}; the kernels' "
          f"device time " + (", ".join(f"{k} {t:.3f} ms x{c}" for k, (t, c)
                                       in parts.items() if c)
                             or "not measured: no profiler rows")
          + f"); host {got['host_ms']:.3f} ms a call; the norm alone "
          f"{got['norm_ms']:.3f} ms (bound {norm_bound:.3f}); plain loop "
          f"{got['plain_ms']:.3f} ms (host {got['plain_host_ms']:.3f}), "
          f"plain norm {got['plain_norm_ms']:.3f} ms; library: "
          f"clip_grad_norm_ + AdamW(fused=True) {got['library_ms']:.3f} ms "
          f"(the step alone {got['library_step_ms']:.3f}, the foreach norm "
          f"{got['library_norm_ms']:.3f}) [{card}]", flush=True)
    return {**got, "bound_ms": bound, "norm_bound_ms": norm_bound,
            "max_abs_err": err, "norm_err": norm_err}


def qwen3_minicpm_phase(card, configs, lm, serve, train, fa, ref, aw,
                        counters) -> dict:
    """Phase 5e, after Whisper-small, the card's memory released before
    each model: the flash forward and backward at Qwen3-14B's (HD128) and
    MiniCPM-2B's (MINICPM_SHAPE) prefill and training shapes in bf16
    against the plain twins (the forward's output within 2e-2 max abs and
    its lse within 1e-4, the backward's dq, dk and dv within 2e-2 relative
    max) and timed beside SDPA and their bounds, the backward's three
    launches by profiler; AdamW's kernels at MiniCPM-2B's leaves
    (`adamw_phase`); both models served at every published width and
    full depth (`full_depth_serve`: exactly 40 flash forwards a serve and
    nothing else, each layer's attention and the prefill logits within
    2e-2 of the plain twins, prefill ms, decode ms/token, peak memory);
    MiniCPM-2B trained at full depth and Qwen3-14B at every published
    width, cut to QWEN3_TRAIN_LAYERS (`dense_train`: 2n flash forwards and
    n backwards a step and AdamW's kernels over every leaf, the loss
    within 2e-2 and each gradient leaf within GRAD_BAR of the plain
    twins', MiniCPM's tied table one leaf).  Returns {"kernels": {arch:
    {"fwd": time_flash's, "bwd": time_flash_bwd's, "errs": (forward max
    abs, backward max abs)}, "adamw": adamw_phase's}, "served": {arch:
    full_depth_serve's}, "trained": {arch: dense_train's}}."""
    lap = time.perf_counter()
    torch.cuda.empty_cache()
    kernels = {}
    for arch, case in ((QWEN3_ARCH, HD128), (MINICPM_ARCH, MINICPM_SHAPE)):
        q, k, v = qkv(case, torch.bfloat16)
        seen = seen_rows(case)
        fwd_err = check_forward(fa, ref, case, torch.bfloat16, q, k, v, seen)
        _, bwd_err = check_backward(fa, case, torch.bfloat16, q, k, v, seen)
        del q, k, v
        kernels[arch] = {"fwd": time_flash(fa, case, card),
                         "bwd": time_flash_bwd(fa, ref, case, card),
                         "errs": (fwd_err, bwd_err)}
        bwd_parts(fa, case, card)
    lap = phase_seconds("5e, the kernels at both shapes", lap)
    kernels["adamw"] = adamw_phase(card, configs, lm, aw)
    lap = phase_seconds("5e, AdamW's kernels", lap)
    served = {}
    for arch in (QWEN3_ARCH, MINICPM_ARCH):
        served[arch] = full_depth_serve(card, configs, lm, serve, fa,
                                        counters, arch)
        lap = phase_seconds(f"5e, {arch} served", lap)
    torch.cuda.empty_cache()
    trained = {MINICPM_ARCH: dense_train(card, configs.get(MINICPM_ARCH),
                                         MINICPM_TRAIN_BATCH, lm, train,
                                         counters)}
    lap = phase_seconds(f"5e, {MINICPM_ARCH} trained", lap)
    torch.cuda.empty_cache()
    full = configs.get(QWEN3_ARCH)
    print(f"train {QWEN3_ARCH}: every published width, depth cut to "
          f"{QWEN3_TRAIN_LAYERS} of {full.n_layers} layers, batch "
          f"{QWEN3_TRAIN_BATCH} x {PROMPT}", flush=True)
    trained[QWEN3_ARCH] = dense_train(
        card, cut_config(full, QWEN3_TRAIN_LAYERS), QWEN3_TRAIN_BATCH, lm,
        train, counters)
    phase_seconds(f"5e, {QWEN3_ARCH} trained", lap)
    return {"kernels": kernels, "served": served, "trained": trained}


def scan_inputs(case, seed: int = 0) -> tuple:
    """The scan's float32 arguments at one SCAN_CASES case, on the card:
    (dt, u, b, c, a, h0) with dt = softplus(N(0, 1)) (strong: U[6, 10]),
    u, B, C ~ N(0, 1), a = -(1 .. N) x e^(0.1 N(0, 1)), h0 ~ 0.3 N or
    None; then the gradients dy ~ N(0, 1) and dh_last ~ 0.1 N."""
    bsz, s, di, n, with_h0, strong = case
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = (6 + 4 * torch.rand((bsz, s, di), generator=g, device="cuda")
          if strong else torch.nn.functional.softplus(randn(bsz, s, di)))
    u, b, c = randn(bsz, s, di), randn(bsz, s, n), randn(bsz, s, n)
    a = -torch.arange(1, n + 1, device="cuda") * torch.exp(
        0.1 * randn(di, n))
    h0 = 0.3 * randn(bsz, di, n) if with_h0 else None
    return (dt, u, b, c, a, h0), randn(bsz, s, di), 0.1 * randn(bsz, di, n)


def check_scan(ss, ref) -> tuple:
    """Phase 2 for the selective scan over SCAN_CASES: the forward's y and
    h_last against the plain loop and its checkpoints against
    `ref.ssm_checkpoints` within SCAN_FWD_BAR, y and h_last with
    checkpoints bitwise equal to serving's (without); the backward's ddt,
    du, dB, dC, da and dh0 with a random dh_last (and at SCAN_MAIN also
    without, as training calls it) against `ref.ssm_scan_bwd_plain` as
    SCAN_BWD_BAR says, all finite; two backward calls at SCAN_MAIN
    bitwise equal.  Returns the max abs errors (forward y, backward) at
    SCAN_MAIN without dh_last."""
    main = None
    edges = {ss.CHUNK - 1, ss.CHUNK, ss.CHUNK + 1}
    if not edges <= {case[1] for case in SCAN_CASES}:
        fail(f"SCAN_CASES miss the chunk edges S = {sorted(edges)}")
    for case in SCAN_CASES:
        args, dy, dhl = scan_inputs(case)
        y, hl, ck = ss.selective_scan_fwd(*args, want_ckpt=True)
        y_serve, hl_serve = ss.selective_scan(*args)
        want_y, want_h = ss.ssm_scan_plain(*args)
        want_ck = ref.ssm_checkpoints(args[0], args[1], args[2], args[4],
                                      args[5], ss.CKPT_EVERY)
        fwd = {"y": rel_err(y, want_y), "h_last": rel_err(hl, want_h),
               "ckpt": rel_err(ck, want_ck)}
        y_abs = (y - want_y).abs().max().item()
        same = torch.equal(y, y_serve) and torch.equal(hl, hl_serve)
        fwd_ok = (same and max(fwd.values()) <= SCAN_FWD_BAR
                  and all(torch.isfinite(t).all().item() for t in (y, hl)))
        for dh_last in ((dhl, None) if case is SCAN_MAIN else (dhl,)):
            got = ss.selective_scan_bwd(*args, dy, dh_last, ck)
            want = ref.ssm_scan_bwd_plain(*args, dy, dh_last,
                                          ckpt_every=ss.CKPT_EVERY)
            torch.cuda.synchronize()
            errs, ok = {}, fwd_ok
            for name, a, b in zip(("ddt", "du", "db", "dc", "da", "dh0"),
                                  got, want):
                errs[name] = (a - b).abs().max().item()
                bar = 1e-4 * max(b.abs().max().item(), 1)
                ok = (ok and errs[name] <= bar
                      and torch.isfinite(a).all().item())
            print(json.dumps({"scan_case": list(case),
                              "dh_last": dh_last is not None,
                              "fwd_rel_max_err": fwd,
                              "fwd_bar": SCAN_FWD_BAR,
                              "y_with_ckpt_equal": same,
                              "bwd_max_abs_err": errs,
                              "bwd_bar": SCAN_BWD_BAR, "ok": ok}),
                  flush=True)
            if not ok:
                fail(f"selective_scan {case}: forward {fwd} (y equal "
                     f"{same}), backward {errs}")
            if case is SCAN_MAIN and dh_last is None:
                main = (y_abs, max(errs.values()))
        del args, dy, dhl, y, hl, ck, want_y, want_h, want_ck, got, want
    args, dy, _ = scan_inputs(SCAN_MAIN)
    _, _, ck = ss.selective_scan_fwd(*args, want_ckpt=True)
    first = ss.selective_scan_bwd(*args, dy, None, ck)
    second = ss.selective_scan_bwd(*args, dy, None, ck)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(json.dumps({"scan_bwd_deterministic": list(SCAN_MAIN),
                      "bitwise_equal_ddt_du_db_dc_da_dh0": same}), flush=True)
    if not all(same):
        fail(f"selective_scan_bwd {SCAN_MAIN}: two calls differ ({same})")
    return main


def scan_bound(case, backward: bool = False,
               ckpt: bool = False) -> tuple[float, str]:
    """Least time (ms) for the scan at one case.  Bytes, each read and
    written once: the forward reads dt, u, B, C, a (and h0) and writes y
    and h_last (and, with `ckpt`, h every CKPT_EVERY tokens); the backward
    reads dt, u, dy, B, C, a and the checkpoints (dh_last as training
    calls it: none) and writes ddt, du, dB, dC, da and dh0.  Operations:
    one expf per (b, t, d, n) at PEAK_MUFU, or its fp32 operations (7 a
    forward, 16 a backward) at PEAK_F32_FLOPS, the larger."""
    bsz, s, di, n, with_h0 = case[:5]
    el, bsn, state = bsz * s * di, bsz * s * n, bsz * di * n
    nck = -(-s // 32)
    if backward:
        nbytes = 4 * (5 * el + 4 * bsn + 2 * di * n + state
                      + bsz * nck * di * n)
    else:
        nbytes = 4 * (3 * el + 2 * bsn + di * n + (2 if with_h0 else 1) * state
                      + (bsz * nck * di * n if ckpt else 0))
    t_ops = max(el * n / PEAK_MUFU,
                (16 if backward else 7) * el * n / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_launches(fn, calls: int = 10) -> str:
    """Each launch of a scan call by profiler device time: the kernel's
    name, its mean ms a launch and how many launches of `calls` calls of fn
    the profile holds (a profile can lose the first calls' kernels)."""
    rows = [e for e in device_kernels(lambda: [fn() for _ in range(calls)])
            if "ssm_scan" in e.key]
    return ", ".join(f"{re.search(r'ssm_scan_[a-z]+_kernel', e.key)[0]} "
                     f"{e.self_device_time_total / 1e3 / e.count:.4f} ms "
                     f"({e.count} launches)" for e in rows) or "not measured"


def time_scan(ss, ref, card) -> dict:
    """Phase 4a for the scan at SCAN_MAIN (Hymba-1.5B's prefill and
    training shape, no h0): the forward without checkpoints (serving's)
    and with, beside the plain loop; the backward beside its plain twin;
    each call's launches by profiler device time; each with its bound.
    Returns {"forward" | "backward": (ms, plain_ms, bound_ms, bound_by)}."""
    args, dy, _ = scan_inputs(SCAN_MAIN)
    fwd_ms = time_ms(lambda: ss.selective_scan(*args), 20)
    ck_ms = time_ms(lambda: ss.selective_scan_fwd(*args, want_ckpt=True), 20)
    plain_ms = time_ms(lambda: ss.ssm_scan_plain(*args), 2, warmup=1)
    _, _, ck = ss.selective_scan_fwd(*args, want_ckpt=True)

    def bwd():
        ss.selective_scan_bwd(*args, dy, None, ck)
    bwd_ms = time_ms(bwd, 20)
    bwd_plain_ms = time_ms(lambda: ref.ssm_scan_bwd_plain(
        *args, dy, None, ckpt_every=ss.CKPT_EVERY), 1, warmup=1)
    parts = {"forward": scan_launches(lambda: ss.selective_scan(*args)),
             "with checkpoints": scan_launches(
                 lambda: ss.selective_scan_fwd(*args, want_ckpt=True)),
             "backward": scan_launches(bwd)}
    fwd_b, bwd_b = scan_bound(SCAN_MAIN), scan_bound(SCAN_MAIN, backward=True)
    ck_b = scan_bound(SCAN_MAIN, ckpt=True)
    expf_ms = math.prod(SCAN_MAIN[:4]) / PEAK_MUFU * 1e3
    print(f"selective_scan {SCAN_MAIN[:4]} fp32 without h0, chunks of "
          f"{ss.CHUNK}: forward {fwd_ms:.4f} ms by CUDA events, bound "
          f"{fwd_b[0]:.4f} ms ({fwd_b[1]}); with checkpoints {ck_ms:.4f} ms "
          f"(bound {ck_b[0]:.4f} ms, {ck_b[1]}); the plain loop "
          f"{plain_ms:.4f} ms; backward {bwd_ms:.4f} ms, bound "
          f"{bwd_b[0]:.4f} ms ({bwd_b[1]}), plain {bwd_plain_ms:.4f} ms; "
          f"the exps alone at the MUFU rate {expf_ms:.4f} ms [{card}]",
          flush=True)
    for name, part in parts.items():
        print(f"selective_scan {name} by launch (profiler device time, 10 "
              f"calls): {part} [{card}]", flush=True)
    return {"forward": (fwd_ms, plain_ms, *fwd_b),
            "backward": (bwd_ms, bwd_plain_ms, *bwd_b)}


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


def wkv_bound(case, every: int | None = None) -> tuple[float, str]:
    """Least time (ms): r, k, v, w, u and s0 read once, y and s_final (and
    given `every`, the state every `every` tokens) written once, against
    the recurrence's 4*B*S*H*hd^2 fp32 operations."""
    b, s, h, hd, _, _, with_s0, _ = case
    nbytes = 4 * (5 * b * s * h * hd + h * hd
                  + (2 if with_s0 else 1) * b * h * hd * hd
                  + (-(-s // every) * b * h * hd * hd if every else 0))
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


def serve_counted(serve, arch, counters, prompt: int = PROMPT) -> tuple:
    """Phase 3 for one model: every launch counter set to 0 just before
    `serve.main` (batch BATCH, `prompt` tokens, GEN new ones), read just
    after.  Returns (tokens, {kernel: launches}, seconds)."""
    set_counts(counters)
    t0 = time.perf_counter()
    toks = serve.main(["--arch", arch, "--batch", str(BATCH),
                       "--prompt-len", str(prompt), "--gen", str(GEN)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return toks, read_counts(counters), dt


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
            cache=lm._init_block_cache(cfg, seg, BATCH, 0, dev))[0]
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
    want = counts(wkv6=cfg.n_layers * GEN)
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
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
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


# Each wkv6 launch site has an entry of its own, so a profile's row names
# the launch that made it: the forward (serving's, or training's with
# checkpoints: `wkv6_kernel`) and the backward's three launches.
WKV6_BWD_KERNELS = {"wkv6_rev_kernel": "reverse pass",
                    "wkv6_pair_kernel": "span walk by pairs",
                    "wkv6_du_kernel": "du sum"}


def wkv6_parts(rows) -> dict:
    """A profile's wkv6 rows: the forward and the backward."""
    return {"forward": [e for e in rows if "wkv6_kernel" in e.key],
            "backward": [e for e in rows if any(
                n in e.key for n in WKV6_BWD_KERNELS)]}


def wkv6_name(key: str) -> str:
    """A profiler row's wkv6 kernel, short: the entry's name and what it
    does (the forward: with checkpoints or without)."""
    name = re.search(r"wkv6_\w*kernel", key)[0]
    if name == "wkv6_kernel":
        return name + (" (checkpoints)" if "true>" in key else " (serving)")
    return f"{name} ({WKV6_BWD_KERNELS[name]})"


def wkv_bwd_inputs(case, seed=3):
    """The backward's arguments at one WKV case, but the checkpoints: the
    forward's inputs, dy ~ N(0, 1) and ds_final ~ 0.1 N."""
    r, k, v, w, u, s0 = wkv_inputs(case)
    g = torch.Generator("cuda").manual_seed(seed)
    dy = torch.randn(r.shape, generator=g, device="cuda")
    dsf = 0.1 * torch.randn(s0.shape if s0 is not None else
                            (r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                            generator=g, device="cuda")
    return r, k, v, w, u, s0, dy, dsf


WKV_BWD_BAR = "|got - want| <= 1e-4 x max(max |want|, 1), each output"


def check_wkv6_bwd(wkv, ref) -> float:
    """Phase 2 for the wkv6 backward: over WKV_CASES (the decode shape S = 1
    among them), with a random ds_final (and at the main shape also
    without, as training calls it), dr, dk, dv, dw, du and ds0 against
    `ref.wkv6_bwd_plain` within WKV_BWD_BAR; the forward's checkpoints
    against the plain recurrence's states (WKV_BAR) and its y with them
    bitwise equal to y without; and two backward calls at the main shape
    bitwise equal.  Returns the max abs error at the main shape."""
    main_err = None
    for case in WKV_CASES:
        r, k, v, w, u, s0, dy, dsf = wkv_bwd_inputs(case)
        y, _, ck = wkv.wkv6_fwd(r, k, v, w, u, s0, chunk=case[4],
                                want_ckpt=True)
        y_serve, _ = wkv.wkv6(r, k, v, w, u, s0, chunk=case[4])
        ok_ck, err_ck = wkv_ok(ck, ref.wkv6_checkpoints(k, v, w, s0,
                                                        wkv.CKPT_EVERY))
        same_y = torch.equal(y, y_serve)
        for ds_final in ((dsf, None) if case is WKV_MAIN else (dsf,)):
            *got, gck = wkv.bwd_launch(wkv._bwd(), r, k, v, w, u, s0, dy,
                                       ds_final, ck, case[4])
            want = ref.wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_final,
                                      ckpt_every=wkv.CKPT_EVERY)
            ok_g, err_g = wkv_ok(gck, ref.wkv6_grad_checkpoints(
                r, w, dy, ds_final, wkv.CKPT_EVERY))
            torch.cuda.synchronize()
            errs, ok = {}, ok_ck and same_y and ok_g
            for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                                  want):
                if name == "ds0" and s0 is None:
                    continue
                err = (a - b).abs().max().item()
                bar = 1e-4 * max(b.abs().max().item(), 1.0)
                errs[name] = err
                ok = ok and err <= bar and torch.isfinite(a).all().item()
            print(json.dumps({"wkv6_bwd_case": list(case),
                              "ds_final": ds_final is not None,
                              "max_abs_err": errs, "bar": WKV_BWD_BAR,
                              "ckpt_max_abs_err": err_ck,
                              "grad_ckpt_max_abs_err": err_g,
                              "y_with_ckpt_equal": same_y, "ok": ok}),
                  flush=True)
            if not ok:
                fail(f"wkv6_bwd {case}: errors {errs}, checkpoints {err_ck}"
                     f" ({ok_ck}), the reverse pass's {err_g} ({ok_g}), y "
                     f"equal {same_y}")
            if case is WKV_MAIN and ds_final is None:
                main_err = max(errs.values())
        del r, k, v, w, u, s0, dy, dsf, y, ck, got, gck, want
    r, k, v, w, u, _, dy, _ = wkv_bwd_inputs(WKV_MAIN)
    _, _, ck = wkv.wkv6_fwd(r, k, v, w, u, want_ckpt=True)
    first = wkv.wkv6_bwd(r, k, v, w, u, None, dy, None, ck)
    second = wkv.wkv6_bwd(r, k, v, w, u, None, dy, None, ck)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(json.dumps({"wkv6_bwd_deterministic": list(WKV_MAIN),
                      "bitwise_equal_dr_dk_dv_dw_du_ds0": same}), flush=True)
    if not all(same):
        fail(f"wkv6_bwd {WKV_MAIN}: two calls differ ({same})")
    return main_err


def wkv_bwd_bound(case, every: int) -> tuple[float, str]:
    """Least time (ms) for the backward: r, k, v, w, dy, u and the
    checkpoints (every `every` tokens) read, dr, dk, dv, dw, du and ds0
    written once, against its 14 B S H hd^2 fp32 operations (the state's
    recompute 3, G's update 3, and 2 each for dr, dk, dv, dw, per state
    element and token)."""
    b, s, h, hd = case[:4]
    nck = -(-s // every)
    nbytes = 4 * (9 * b * s * h * hd + 2 * h * hd
                  + (nck + 1) * b * h * hd * hd)
    return roofline(14.0 * b * s * h * hd * hd, nbytes, PEAK_F32_FLOPS)


def time_wkv6_train(wkv, ref, card) -> tuple:
    """Phase 4a for training at the main shape (training calls it without
    s0): the forward with its checkpoints beside the forward without
    (serving's), and the backward against its plain twin and its bound,
    with where a call's time goes: its three launches by profiler, their
    sum and their span, and the host's time per call.  Returns (ms,
    plain_ms, bound_ms, bound_by) of the backward."""
    r, k, v, w, u, _, dy, _ = wkv_bwd_inputs(WKV_MAIN)
    fwd_ms = time_ms(lambda: wkv.wkv6(r, k, v, w, u), 20)
    ck_ms = time_ms(lambda: wkv.wkv6_fwd(r, k, v, w, u, want_ckpt=True), 20)
    fwd_ms2 = time_ms(lambda: wkv.wkv6(r, k, v, w, u), 20)
    _, _, ck = wkv.wkv6_fwd(r, k, v, w, u, want_ckpt=True)

    def bwd():
        wkv.wkv6_bwd(r, k, v, w, u, None, dy, None, ck)
    ms = time_ms(bwd, 20)
    plain_ms = time_ms(lambda: ref.wkv6_bwd_plain(r, k, v, w, u, None, dy,
                                                  None), 2, warmup=1)
    # the forward's plain twin without s0 (it writes no checkpoints)
    fwd_plain_ms = time_ms(lambda: wkv.wkv6_plain(r, k, v, w, u), 2,
                           warmup=1)
    bound_ms, bound_by = wkv_bwd_bound(WKV_MAIN, wkv.CKPT_EVERY)
    no_s0 = WKV_MAIN[:6] + (False,) + WKV_MAIN[7:]
    ck_bound = wkv_bound(no_s0, wkv.CKPT_EVERY)
    rows = device_kernels(lambda: [bwd() for _ in range(10)])
    parts = ", ".join(f"{wkv6_name(e.key)} "
                      f"{e.self_device_time_total / 1e3 / e.count:.4f} ms "
                      f"x{e.count}"
                      for e in rows if "wkv6" in e.key) or "not measured"
    busy, span = device_span(bwd, "wkv6", 10, 3)
    host = host_ms(bwd, 20)
    print(f"wkv6 {WKV_MAIN[:4]} fp32 without s0: forward {fwd_ms:.4f} / "
          f"{fwd_ms2:.4f} ms (bound {wkv_bound(no_s0)[0]:.4f} ms), with "
          f"checkpoints {ck_ms:.4f} ms (bound {ck_bound[0]:.4f} ms, "
          f"{ck_bound[1]}), the plain twin {fwd_plain_ms:.4f} ms; backward "
          f"{ms:.4f} ms by CUDA events (per "
          f"launch, profiler: {parts}; launches summed "
          + ("not measured" if busy is None else
             f"{busy:.4f} ms, first start to last end {span:.4f} ms")
          + f"; host time of one wrapper call {host:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]",
          flush=True)
    return ms, plain_ms, bound_ms, bound_by


def rwkv_train(card, configs, lm, train, wkv, ref, counters) -> dict:
    """Phases 3-5 for RWKV6-3B training: `train_path` at every published
    width and full depth (batch RWKV_TRAIN_BATCH x seq 2048, fp32 masters,
    remat full: exactly 2 wkv6 forwards and 1 wkv6 backward a layer a
    step), the step through the kernels against the plain twins at
    RWKV_CHECK_LAYERS layers, and the backward's timings.  Returns the
    wkv6_bwd entry of the kernels line."""
    t0 = time.perf_counter()
    cfg = configs.get(RWKV_ARCH)
    trained = train_path(card, cfg, RWKV_TRAIN_BATCH, train, counters)
    cut = dataclasses.replace(cfg, n_layers=RWKV_CHECK_LAYERS)
    print(f"train {RWKV_ARCH} kernels vs plain: every published width, "
          f"depth cut to {RWKV_CHECK_LAYERS} of {cfg.n_layers} layers (the "
          "plain recurrence's per-token autograd graph costs ~5.4 GB and "
          "~1 s a layer)", flush=True)
    train_vs_plain(card, cut, RWKV_TRAIN_BATCH, lm)
    ms, plain_ms, bound_ms, bound_by = time_wkv6_train(wkv, ref, card)
    torch.cuda.empty_cache()
    print(f"rwkv training phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"name": "wkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            # no TPU kernel: the VJP of the lax.scan the JAX package
            # differentiates
            "replaces": "src/repro/models/blocks.py:381",
            "launches": trained["launches"]["wkv6_bwd"], "max_abs_err": None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
    return record, on_cpu.summary()


def csv_rel(path: Path, want: list, where: str) -> float:
    """Largest relative difference between a CSV written by the CLI and
    in-process rows; fails on a label, header or row count that differs."""
    with open(path, newline="") as f:
        got = list(csv.DictReader(f))
    if len(got) != len(want):
        fail(f"{where}: {len(got)} rows != {len(want)}")
    err = 0.0
    for g, w in zip(got, want):
        if list(g) != list(w):
            fail(f"{where}: columns {list(g)} != {list(w)}")
        for k, v in w.items():
            if isinstance(v, float):
                err = max(err, abs(float(g[k]) - v) / max(abs(v), 1e-300))
            elif g[k] != str(v):
                fail(f"{where}: {k} {g[k]!r} != {v!r}")
    return err


def service_phase(card, mega_summary) -> dict:
    """Phase 7: the DTCO analyses, the sweep CLI and the sweep service
    (`repro_torch.sweep`) on the card, the CLI and the service through
    their real entry points as subprocesses.  `mega_summary` is the
    pipeline phase's CPU run of the mega spec.  Returns the
    `{"service": ...}` record."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import scenarios
    from repro_torch.core import dtco, sweep
    from repro_torch.sweep import client
    from repro_torch.sweep import service as service_mod
    from repro_torch.sweep.service import SweepService
    dev = "cuda"
    t_phase = time.perf_counter()
    print(f"service: {card}", flush=True)
    errs = {}

    # 1. the cross-node DTCO studies on the card
    for name, study, head in (
            ("dtco", dtco.analyze, dtco.headline),
            ("dtco_isoarea", dtco.isoarea_analyze, dtco.isoarea_headline)):
        rows = study(device=dev)
        errs[f"{name}_headline_vs_reference"] = held(
            f"{name} headline (cuda) vs the JAX reference",
            nested_rel(head(rows), PIPELINE_GOLDEN[f"{name}_headline"],
                       name))
        errs[f"{name}_rows_vs_cpu"] = held(
            f"{name} rows, cuda vs cpu", nested_rel(
                [dataclasses.asdict(r) for r in rows],
                [dataclasses.asdict(r) for r in study(device="cpu")], name))

    # 2. the CLI as a user runs it (on cuda: no --device)
    docs = {n: json.loads((ROOT / "specs" / f"{n}.json").read_text())
            for n in SERVICE_GOLDENS}
    on_cpu = {n: sweep.SymbolicSweepSpec.from_json(d).run(device="cpu")
              for n, d in docs.items()}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out_dir = ROOT / "runs" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "dtco.csv"
    t = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "run", "specs/dtco.json",
         "--csv", str(csv_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    cli_s = time.perf_counter() - t
    if done.returncode:
        fail(f"sweep CLI run exited {done.returncode}: {done.stderr[-2000:]}")
    print(f"  CLI: {done.stderr.strip()} ({cli_s:.2f} s with the "
          "interpreter and the CUDA context)", flush=True)
    errs["cli_dtco_rows_vs_cpu"] = held(
        "CLI run specs/dtco.json (cuda) vs sweep.run (cpu)",
        csv_rel(csv_path, on_cpu["dtco"].rows(), "cli/dtco"))
    cuda_dtco = sweep.SymbolicSweepSpec.from_json(docs["dtco"]).run(
        device=dev)
    if [str(d.org) for d in cuda_dtco.designs] \
            != [str(d.org) for d in on_cpu["dtco"].designs]:
        fail("dtco: tuned organizations on cuda differ from the CPU's")

    # 3. the service through its real entry point
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.sweep", "serve", "--http",
         "127.0.0.1:0", "--warmup-spec", "specs/isocap.json",
         "--stats-on-exit"], cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        while url is None:
            line = proc.stderr.readline()
            if not line:
                fail(f"sweep service exited {proc.wait()} before listening")
            print(f"  serve: {line.rstrip()}", flush=True)
            if line.startswith("listening on http://"):
                url = line.split("http://", 1)[1].strip()
        startup_s = time.perf_counter() - t
        sent = 0

        def request(body):
            nonlocal sent
            sent += 1
            t = time.perf_counter()
            resp = client.http_request(url, body, timeout=300.0)
            if not resp.get("ok"):
                fail(f"service request failed: {resp.get('error')}")
            return resp, time.perf_counter() - t

        def check(resp, name, views=("summary",)):
            err = 0.0
            for view in views:
                want = on_cpu[name].rows() if view == "rows" \
                    else on_cpu[name].summary()
                err = max(err, nested_rel(resp[view], want,
                                          f"service/{name}/{view}"))
            return err

        cold, cold_s = request({"spec": docs["lm_nvm"], "want": ["summary"]})
        warm, warm_s = request({"spec": docs["isocap"], "want": ["summary"]})
        if (cold["source"], warm["source"]) != ("evaluated", "evaluated"):
            fail(f"first requests: sources {cold['source']}, "
                 f"{warm['source']}")
        errs["service_first_requests_vs_cpu"] = held(
            "service cold (lm_nvm) and warm (isocap) first requests vs cpu",
            max(check(cold, "lm_nvm"), check(warm, "isocap")))
        print(f"  first requests: cold (lm_nvm) {cold_s:.4f} s, warm "
              f"(isocap) {warm_s:.4f} s", flush=True)
        names = [n for n in SERVICE_GOLDENS for _ in range(SERVICE_COPIES)]
        cells = sum(sweep.n_cells(on_cpu[n].spec) for n in names)

        def burst(want):
            nonlocal sent
            sent += len(names)
            with ThreadPoolExecutor(max_workers=len(names)) as pool:
                t = time.perf_counter()
                out = list(pool.map(lambda n: client.http_request(
                    url, {"spec": docs[n], "want": [want]}, timeout=300.0),
                    names))
                sec = time.perf_counter() - t
            for resp in out:
                if not resp.get("ok"):
                    fail(f"burst request failed: {resp.get('error')}")
            return out, sec

        summaries, burst_s = burst("summary")
        sources = {s: sum(r["source"] == s for r in summaries)
                   for s in ("evaluated", "coalesced", "cache")}
        rows, rows_burst_s = burst("rows")
        if any(r["source"] != "cache" for r in rows):
            fail("the second burst was not answered from the cache")
        errs["service_bursts_vs_cpu"] = held(
            f"service bursts ({len(names)} requests, {cells} cells; "
            "summary, then rows) vs cpu",
            max(check(r, n, (v,)) for v, out in (("summary", summaries),
                                                 ("rows", rows))
                for r, n in zip(out, names)))
        print(f"  burst of {len(names)}: {burst_s:.4f} s ({sources}); the "
              f"rows burst from the cache {rows_burst_s:.4f} s", flush=True)

        # the mega spec as one sharded request
        mega_req = {"spec": sweep.SymbolicSweepSpec.from_spec(
            scenarios.mega_spec()).to_doc(), "want": ["summary"],
            "shard": dict(MEGA_PLAN)}
        mega, mega_s = request(mega_req)
        if (mega["cells"], mega["source"]) != (104_832, "sharded"):
            fail(f"mega request: {mega['cells']} cells, {mega['source']}")
        errs["service_mega_vs_cpu"] = held(
            "service mega request (shard envelope) vs the CPU run",
            nested_rel(mega["summary"], mega_summary, "service/mega"))
        print(f"  mega request: {len(json.dumps(mega_req))} bytes, "
              f"{mega_s:.4f} s, {mega['cells'] / mega_s:,.0f} cells/s",
              flush=True)

        # SIGTERM with a request in flight: the mega request again, the
        # signal sent once the service has admitted it
        for _ in range(3):
            box = {}
            inflight = threading.Thread(target=lambda: box.update(
                resp=client.http_request(url, mega_req, timeout=300.0)))
            inflight.start()
            while inflight.is_alive() and not client.http_stats(url)[
                    "stats"]["limits"]["pending"]:
                pass
            if inflight.is_alive():
                break
            inflight.join()
            sent += 1
        else:
            fail("no request was in flight when polled (3 tries)")
        sent += 1
        proc.send_signal(signal.SIGTERM)
        _, err_text = proc.communicate(timeout=120)
        inflight.join(120.0)
        if proc.returncode != 0:
            fail(f"sweep service exited {proc.returncode} on SIGTERM")
        if not box.get("resp", {}).get("ok"):
            fail(f"in-flight request not answered: {box}")
        errs["service_inflight_vs_cpu"] = held(
            "service request in flight at SIGTERM vs the CPU run",
            nested_rel(box["resp"]["summary"], mega_summary, "sigterm"))
        stats = json.loads(err_text[err_text.index("{"):])
        if stats["requests"] != {"total": sent, "ok": sent, "errors": 0}:
            fail(f"service stats {stats['requests']} after {sent} requests")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"  SIGTERM with a request in flight: exit 0, response "
          f"delivered; stats {stats['requests']}, cache "
          f"{stats['result_cache']}, coalesce {stats['coalesce']}",
          flush=True)

    # 4. serial against coalesced, in process on the card
    def fire(svc, want="summary"):
        barrier = threading.Barrier(len(names) + 1)
        out = [None] * len(names)

        def shoot(i):
            barrier.wait()
            out[i] = svc.handle({"spec": docs[names[i]], "want": [want]})

        threads = [threading.Thread(target=shoot, args=(i,))
                   for i in range(len(names))]
        for th in threads:
            th.start()
        barrier.wait()
        t = time.perf_counter()
        for th in threads:
            th.join()
        sec = time.perf_counter() - t
        if not all(r["ok"] for r in out):
            fail(f"in-process burst: {[r.get('error') for r in out]}")
        return out, sec

    def serial(svc):
        t = time.perf_counter()
        for n in names:
            if not svc.handle({"spec": docs[n], "want": ["summary"]})["ok"]:
                fail(f"serial request {n} failed")
        return time.perf_counter() - t

    with SweepService(window_ms=1.0, cache_size=0, device=dev) as absorb:
        serial(absorb)          # every member and union shape once
        fire(absorb)
    with SweepService(coalesce=False, cache_size=0, device=dev) as svc:
        serial_runs = [serial(svc) for _ in range(SERVICE_REPS)]
    with SweepService(window_ms=1.0, cache_size=0, device=dev) as svc:
        coal_runs = [fire(svc)[1] for _ in range(SERVICE_REPS)]
        inproc = svc.stats()
        out, _ = fire(svc, "rows")
        errs["inprocess_coalesced_rows_vs_cpu"] = held(
            "in-process coalesced burst rows (cuda) vs cpu",
            max(check(r, n, ("rows",)) for r, n in zip(out, names)))
        prof = device_kernels(lambda: fire(svc))
    serial_s, coal_s = sorted(serial_runs)[1], sorted(coal_runs)[1]

    # where a warm request's host time goes, per golden (median of 3 ms):
    # parsing the document, its cache key, resolving the names, the
    # evaluation on the card (tables memoized), the summary view
    def host_split(doc):
        steps = {"parse": lambda: service_mod._parse(
                     {"spec": doc, "want": ["summary"]}),
                 "key": lambda: service_mod.spec_key(parsed.sym),
                 "resolve": lambda: parsed.sym.resolve(),
                 "evaluate": lambda: service_mod.evaluate_spec(
                     spec, device=dev),
                 "summary": lambda: result.summary()}
        parsed = steps["parse"]()
        spec = steps["resolve"]()
        result = steps["evaluate"]()
        out = {}
        for step, fn in steps.items():
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append(1e3 * (time.perf_counter() - t))
            out[step] = sorted(runs)[1]
        return out

    split_ms = {n: host_split(docs[n]) for n in SERVICE_GOLDENS}
    print(f"  a warm request's host ms by step: {split_ms}", flush=True)
    busy_ms = sum(e.self_device_time_total for e in prof) / 1e3 \
        if prof else None
    busy = busy_ms / (1e3 * coal_s) if prof else None
    print(f"  in process: serial {serial_runs} s, coalesced {coal_runs} s; "
          f"coalesced burst device busy {busy_ms} ms ({busy})", flush=True)
    record = {
        "card": card, "transport": "http", "requests": len(names),
        "cells_per_round": cells,
        "seconds": {"cold_first_request": cold_s,
                    "warm_first_request": warm_s,
                    "warmup": stats["warmup"]["warmup_s"],
                    "startup_to_listening": startup_s,
                    "http_burst": burst_s,
                    "http_rows_burst_cache": rows_burst_s,
                    "cli_run_dtco": cli_s,
                    "serial": serial_s, "coalesced": coal_s,
                    "mega_request": mega_s},
        "serial_runs_s": serial_runs, "coalesced_runs_s": coal_runs,
        "requests_per_s": {"serial": len(names) / serial_s,
                           "coalesced": len(names) / coal_s},
        "cells_per_s": {"serial": cells / serial_s,
                        "coalesced": cells / coal_s,
                        "mega_request": mega["cells"] / mega_s},
        "elapsed_ms": {"inprocess_coalesced": inproc["elapsed_ms"],
                       "http_server": stats["elapsed_ms"]},
        "coalesce": {"inprocess": inproc["coalesce"],
                     "http_server": stats["coalesce"]},
        "http_burst_sources": sources,
        "mega_cells": mega["cells"],
        "max_rel_err": errs, "worst_rel_err": max(errs.values()),
        "warm_request_split_ms": split_ms,
        "coalesced_burst_device_busy_ms": busy_ms,
        "coalesced_burst_device_busy_share": busy,
        "phase_s": time.perf_counter() - t_phase}
    print(f"service phase: {record['phase_s']:.1f} s", flush=True)
    return record


def inverse_phase(card) -> dict:
    """Phase 8: the inverse designer (`repro_torch.inverse`) on the card:
    hardened recovery against the grid winners, the shipped problem
    through `python -m repro_torch.sweep invert` as a subprocess, a wide
    problem (dtco_isoarea: 8 leaf groups, one full chunk of 16 starts) in
    process against the same lowering on the CPU, and its elasticity
    table.  Returns the `{"inverse": ...}` record."""
    import numpy as np
    from repro_torch import inverse
    from repro_torch.core.sweep import SymbolicSweepSpec
    from repro_torch.inverse import driver, relax, sensitivity
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = "cuda"
    t_phase = time.perf_counter()
    print(f"inverse: {card}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    errs = {}

    def problem(name, **kw):
        return inverse.InverseProblem(
            sweep=SymbolicSweepSpec.load(str(ROOT / "specs" / f"{name}.json")),
            objective="edp", name=f"{name}-inv", **kw)

    def same(label, got, want):
        if got != want:
            fail(f"{label}: {got} != {want}")

    # (a) the relaxed pipeline hardened at the centres recovers the grid
    # winner, and the grid is the reference's
    for name, want in INVERSE_GOLDEN["recover"].items():
        prob = problem(name)
        low = relax.lower(prob, device=dev)
        grid = inverse.grid_argmin(prob, low, device=dev)
        rec = inverse.recover_corner(prob, low, device=dev)
        same(f"{name}: recovered corner", rec["corner"], grid["corner"])
        same(f"{name}: grid corner vs the reference", grid["corner"],
             want["corner"])
        errs[f"{name}_recover_vs_grid"] = held(
            f"{name}: hardened centres vs grid argmin (cuda)",
            abs(rec["value"] - grid["value"]) / grid["value"])
        errs[f"{name}_grid_vs_reference"] = held(
            f"{name}: grid value, area, iso budget (cuda) vs the reference",
            nested_rel([grid["value"], grid["area_mm2"],
                        low.area_budget_mm2],
                       [want["value"], want["area_mm2"],
                        want["area_budget_mm2"]], name))

    # (b) the shipped problem through the CLI as a user runs it, and the
    # same solve in process (timed without the interpreter's start)
    gold = INVERSE_GOLDEN["shipped"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out_dir = ROOT / "runs" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    doc_path = out_dir / "inverse_isocap.json"
    t = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "invert",
         "specs/inverse_isocap.json", "--json", str(doc_path)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t
    if done.returncode:
        fail(f"sweep CLI invert exited {done.returncode}: "
             f"{done.stderr[-2000:]}")
    print(f"  CLI invert: {done.stderr.splitlines()[0]} ({cli_s:.2f} s with "
          "the interpreter and the CUDA context)", flush=True)
    doc = json.loads(doc_path.read_text())
    same("shipped: corner vs the reference", doc["corner"], gold["corner"])
    errs["shipped_grid_vs_reference"] = held(
        "shipped: grid_best_value vs the reference",
        nested_rel(doc["grid_best_value"], gold["grid_best_value"]))
    errs["shipped_solve_vs_reference"] = held(
        "shipped: best_value, standard_value vs the reference",
        nested_rel([doc["best_value"], doc["standard_value"]],
                   [gold["best_value"], gold["standard_value"]]),
        INVERSE_SOLVE_REL)
    errs["shipped_parity"] = held("shipped: parity_rel_err (cuda)",
                                  doc["parity_rel_err"])
    if not doc["area_mm2"] <= doc["area_budget_mm2"] * (1.0 + 1e-9):
        fail(f"shipped: area {doc['area_mm2']} over its budget")
    if not doc["best_value"] < doc["grid_best_value"]:
        fail("shipped: the solve does not beat the grid argmin")
    shipped = inverse.InverseProblem.load(
        str(ROOT / "specs" / "inverse_isocap.json"))
    runs_s = []
    for _ in range(2):    # the process's first solve, then a warm one
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = inverse.solve(shipped, device=dev)
        runs_s.append(time.perf_counter() - t)
    shipped_cold_s, shipped_s = runs_s
    errs["shipped_inprocess_vs_cli"] = held(
        "shipped: the in-process solve vs the CLI's (values, leaves)",
        nested_rel({k: res.to_doc()[k] for k in ("corner", "best_value",
                                                  "standard_value",
                                                  "leaves")},
                   {k: doc[k] for k in ("corner", "best_value",
                                        "standard_value", "leaves")},
                   "shipped"), INVERSE_SOLVE_REL)
    print(f"  shipped ({shipped.starts} starts x {shipped.iters} iters): "
          f"best {doc['best_value']!r} vs grid {doc['grid_best_value']!r},"
          f" solve in process {shipped_cold_s:.3f} s the first time, "
          f"{shipped_s:.3f} s warm", flush=True)

    # (c) the wide problem: one full chunk of starts
    wide = problem(INVERSE_WIDE["spec"], starts=INVERSE_WIDE["starts"],
                   iters=INVERSE_WIDE["iters"])
    low = relax.lower(wide, device=dev)
    low_cpu = relax.lower(wide, device="cpu")
    if low.theta0.size != 64 or len(low.groups) != 8:
        fail(f"wide: {len(low.groups)} groups, {low.theta0.size} leaves")
    rng = np.random.default_rng(5)
    offset = low.theta0 + rng.uniform(-0.05, 0.05, low.theta0.size)
    gv = torch.func.grad_and_value(low.loss)
    gv_cpu = torch.func.grad_and_value(low_cpu.loss)
    for where, theta in (("centres", low.theta0), ("offset", offset)):
        for temp in (0.5, relax.HARD_TEMP):
            g, v = gv(torch.from_numpy(theta).to(dev), temp)
            g_cpu, v_cpu = gv_cpu(torch.from_numpy(theta), temp)
            errs[f"wide_loss_{where}_{temp:g}"] = held(
                f"wide: loss at the {where}, temp {temp:g}, cuda vs cpu",
                abs(float(v) - float(v_cpu)) / abs(float(v_cpu)))
            errs[f"wide_grad_{where}_{temp:g}"] = held(
                f"wide: gradient at the {where}, temp {temp:g}, cuda vs "
                "cpu (of its largest component)",
                float((g.cpu() - g_cpu).abs().max() / g_cpu.abs().max()),
                INVERSE_GRAD_REL)
    starts = driver._theta_starts(low)
    torch.cuda.synchronize()
    t = time.perf_counter()
    driver._solve_starts(low, starts)
    descent_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = inverse.solve(wide, device=dev)
    wide_s = time.perf_counter() - t
    errs["wide_parity"] = held("wide: parity_rel_err (cuda)",
                               res.parity_rel_err)
    if not res.area_mm2 <= res.area_budget_mm2 * (1.0 + 1e-9):
        fail(f"wide: area {res.area_mm2} over its budget")
    if not res.best_value <= res.grid_best_value:
        fail(f"wide: best {res.best_value} worse than the grid's "
             f"{res.grid_best_value}")
    finite = sum(1 for x in res.start_losses if math.isfinite(x))
    steps = wide.starts * wide.iters
    # host time of one vmapped step, and the card's share of one chunk
    step = torch.func.vmap(gv, in_dims=(0, None))
    batch = torch.from_numpy(starts).to(dev)
    step_host_ms = host_ms(lambda: step(batch, 0.5), 10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver._solve_starts(low, starts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        if kernels else None
    launches = sum(e.count for e in kernels) / wide.iters if kernels else None
    # the chunk's starts and bounds in, its thetas and losses out: a
    # copy inside the step would show as a count near the iterations
    # (device-to-device copies, a slice's backward, stay on the card)
    copies = sum(e.count for e in kernels
                 if "Memcpy HtoD" in e.key or "Memcpy DtoH" in e.key)
    if copies >= wide.iters:
        fail(f"wide: {copies} host <-> device copies in a chunk of "
             f"{wide.iters} steps")
    busy = busy_ms / (1e3 * descent_s) if kernels else None
    print(f"  wide ({wide.starts} starts x {wide.iters} iters, "
          f"{finite} finite): best {res.best_value!r} vs grid "
          f"{res.grid_best_value!r}; descent {descent_s:.3f} s "
          f"({steps / descent_s:.1f} start-steps/s, "
          f"{1e3 * descent_s / wide.iters:.2f} ms a step, host "
          f"{step_host_ms:.2f} ms a step), solve {wide_s:.3f} s; device "
          f"busy {busy_ms} ms of the descent ({busy}), {launches} device "
          f"kernels a step, {copies} host <-> device copies a chunk",
          flush=True)

    # (d) the elasticity table, cuda against cpu
    t = time.perf_counter()
    rows = sensitivity.sensitivity_rows(wide, low, device=dev)
    sens_s = time.perf_counter() - t
    rows_cpu = sensitivity.sensitivity_rows(wide, low_cpu, device="cpu")
    same("sensitivity: row labels", [
        {k: v for k, v in r.items() if k != "elasticity"} for r in rows],
        [{k: v for k, v in r.items() if k != "elasticity"}
         for r in rows_cpu])
    errs["sensitivity_abs"] = held(
        "sensitivity: elasticities, cuda vs cpu (absolute)",
        max(abs(a["elasticity"] - b["elasticity"])
            for a, b in zip(rows, rows_cpu)), INVERSE_GRAD_REL)
    top, top_cpu = sensitivity.top_knobs(rows), sensitivity.top_knobs(rows_cpu)
    same("sensitivity: top knobs", [(r["node"], r["mem"], r["leaf"])
                                    for r in top],
         [(r["node"], r["mem"], r["leaf"]) for r in top_cpu])
    print(f"  sensitivity: {len(rows)} rows in {sens_s:.3f} s; top knobs "
          f"{[(r['node'], r['mem'], r['leaf']) for r in top]}", flush=True)

    record = {
        "card": card,
        "seconds": {"shipped_solve": shipped_s,
                    "shipped_solve_first": shipped_cold_s,
                    "shipped_cli": cli_s,
                    "wide_solve": wide_s, "wide_descent": descent_s,
                    "wide_sensitivity": sens_s},
        "shipped": {"starts": shipped.starts, "iters": shipped.iters,
                    "best_value": doc["best_value"],
                    "grid_best_value": doc["grid_best_value"],
                    "parity_rel_err": doc["parity_rel_err"],
                    "corner": doc["corner"]["org"]},
        "wide": {"spec": INVERSE_WIDE["spec"], "starts": wide.starts,
                 "iters": wide.iters, "finite_starts": finite,
                 "best_value": res.best_value,
                 "grid_best_value": res.grid_best_value,
                 "parity_rel_err": res.parity_rel_err},
        "start_steps_per_s": {
            "shipped": shipped.starts * shipped.iters / shipped_s,
            "wide_descent": steps / descent_s},
        "step_ms": 1e3 * descent_s / wide.iters,
        "step_host_ms": step_host_ms,
        "device_kernels_per_step": launches,
        "host_device_copies_per_chunk": copies,
        "chunk_device_busy_ms": busy_ms, "chunk_device_busy_share": busy,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_rel_err": errs,
        "phase_s": time.perf_counter() - t_phase}
    print(f"inverse phase: {record['phase_s']:.1f} s", flush=True)
    return record


# ---------------------------------------------------------------------------
# Phase 9: the dry run (`launch.dryrun`) predicted against real runs of the
# same cells, then the dry-run sweep over every arch x shape with its
# roofline rows (`launch.roofline`)
# ---------------------------------------------------------------------------

# (arch, shape kind, the launch counters of the cell's path) at full width
# and depth, batch x sequence DRYRUN_BATCH x DRYRUN_SEQ
DRYRUN_CELLS = (("tinyllama-1.1b", "train",
                 ("flash_attention", "flash_attention_bwd")),
                ("rwkv6-3b", "prefill", ("wkv6",)),
                ("hymba-1.5b", "prefill",
                 ("flash_attention", "selective_scan")))
DRYRUN_BATCH = 4
DRYRUN_SEQ = 2048
# the predicted peak against torch.cuda.max_memory_allocated()
DRYRUN_PEAK_REL = 0.05
DRYRUN_PEAK_ABS = 256 * 2**20
# The sweep's cells in this phase: every shape kind and model family (the
# whole 40-cell sweep took 199.2 s on an H100, over the ~120 s this phase
# may take; `python3 tools/dryrun_sweep.py` runs all of it): dense, MoE,
# MLA, the VLM backbone, the encoder-decoder, RWKV6 and the hybrid; train,
# prefill and decode at their full shapes, long_500k traced and skipped
DRYRUN_SWEEP = (("tinyllama-1.1b", "train_4k"),
                ("tinyllama-1.1b", "long_500k"),
                ("deepseek-moe-16b", "prefill_32k"),
                ("deepseek-v3-671b", "decode_32k"),
                ("chameleon-34b", "decode_32k"),
                ("whisper-small", "prefill_32k"),
                ("rwkv6-3b", "decode_32k"),
                ("hymba-1.5b", "long_500k"))


def dryrun_shape(kind: str):
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec(f"{kind}_{DRYRUN_SEQ}", DRYRUN_SEQ, DRYRUN_BATCH, kind)


def finite_out(out, name: str) -> None:
    """The step's output: a train step's loss, a serving step's logits."""
    t = out[1]["loss"] if isinstance(out, tuple) else out
    if not bool(torch.isfinite(t).all()):
        fail(f"{name}: the step's output is not finite")


def dryrun_cell_check(card, configs, counters, arch: str, kind: str,
                      path: tuple) -> dict:
    """One cell at full width and depth: the dry run on fake CUDA tensors,
    then the same cell for real, its arguments resident before the peak is
    reset; argument bytes and FLOPs equal, the predicted peak within
    DRYRUN_PEAK_REL + DRYRUN_PEAK_ABS of the measured one, the path's
    kernels launched by the real run and by no fake one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, specs
    cfg, shape = configs.get(arch), dryrun_shape(kind)
    name = f"{arch}/{shape.name}"
    torch.cuda.empty_cache()
    set_counts(counters)
    t0 = time.perf_counter()
    with FakeTensorMode():
        cell = specs.build_cell(cfg, shape, device="cuda")
        pred = dryrun.dry_run(cell)
    fake_s = time.perf_counter() - t0
    del cell
    fake_counts = read_counts(counters)
    if any(fake_counts.values()):
        fail(f"{name}: the dry run launched kernels: {fake_counts}")
    base = torch.cuda.memory_allocated()
    cell = specs.build_cell(cfg, shape, device="cuda")
    arg_bytes = dryrun.tensor_bytes(cell.args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(counters)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops:
        out = cell.step_fn(*cell.args)
    torch.cuda.synchronize()
    real_ms = (time.perf_counter() - t0) * 1e3
    got = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() - base
    finite_out(out, name)
    del out, cell
    mem = pred["memory"]
    err = abs(mem["peak_bytes"] - peak)
    print(f"dry run {name}: traced in {fake_s:.2f} s; arguments "
          f"{mem['argument_bytes']} B predicted, {arg_bytes} B real; peak "
          f"{mem['peak_bytes']} B predicted, {peak} B measured "
          f"(max_memory_allocated less what was resident before; "
          f"{err / peak:.4%} off); FLOPs {pred['cost']['flops']} predicted, "
          f"{flops.get_total_flops()} real; the real step {real_ms:.1f} ms; "
          f"launches {got} [{card}]", flush=True)
    if mem["argument_bytes"] != arg_bytes:
        fail(f"{name}: predicted arguments {mem['argument_bytes']} B, real "
             f"{arg_bytes} B")
    if err > DRYRUN_PEAK_REL * peak + DRYRUN_PEAK_ABS:
        fail(f"{name}: predicted peak {mem['peak_bytes']} B, measured "
             f"{peak} B: beyond {DRYRUN_PEAK_REL:.0%} + "
             f"{DRYRUN_PEAK_ABS >> 20} MiB")
    if pred["cost"]["flops"] != flops.get_total_flops():
        fail(f"{name}: FLOPs {pred['cost']['flops']} traced, "
             f"{flops.get_total_flops()} real")
    if not all(got[k] > 0 for k in path):
        fail(f"{name}: a kernel of the path never launched: {got}")
    return {"argument_bytes": arg_bytes, "peak_predicted": mem["peak_bytes"],
            "peak_measured": peak, "flops": pred["cost"]["flops"],
            "launches": {k: got[k] for k in path}, "trace_s": round(fake_s, 2)}


def kv_fp8_decode(card, configs) -> dict:
    """TinyLlama's decode cell for real with the fp8 (e4m3) KV cache and
    with the bf16 one: the fp8 cache half the bytes, its logits finite."""
    from repro_torch.launch import dryrun, specs
    cfg, shape = configs.get(ARCH), dryrun_shape("decode")
    got = {}
    for dtype in (torch.float8_e4m3fn, torch.bfloat16):
        cell = specs.build_cell(cfg, shape, device="cuda",
                                kv_cache_dtype=dtype)
        logits = cell.step_fn(*cell.args)
        got[dtype] = (dryrun.tensor_bytes(cell.args[2]), logits.float())
        del cell
    (fp8_b, fp8_l), (bf_b, bf_l) = got[torch.float8_e4m3fn], got[torch.bfloat16]
    diff = float((fp8_l - bf_l).abs().max())
    print(f"decode {ARCH} {shape.name} (4 x 1 token at index 2047): fp8 "
          f"cache {fp8_b} B, bf16 cache {bf_b} B; logits max |fp8 - bf16| "
          f"{diff:.4e} [{card}]", flush=True)
    if 2 * fp8_b != bf_b:
        fail(f"fp8 KV cache {fp8_b} B is not half the bf16 one's {bf_b} B")
    if not bool(torch.isfinite(fp8_l).all()):
        fail("fp8 KV cache: the decode's logits are not finite")
    return {"fp8_cache_bytes": fp8_b, "bf16_cache_bytes": bf_b,
            "logits_max_abs_diff": diff}


def dryrun_sweep(card, counters) -> list:
    """The dry run of each DRYRUN_SWEEP cell at full size on fake CUDA
    tensors: one roofline row a cell (long_500k skipped for the models
    that are not sub-quadratic), no kernel launched."""
    from repro_torch.launch import dryrun, roofline
    set_counts(counters)
    rows, t0 = [], time.perf_counter()
    for arch, shape in DRYRUN_SWEEP:
        row = roofline.analyze_record(
            dryrun.run_cell(arch, shape, None, device="cuda"))
        rows.append(row)
        if row["status"] == "ok":
            print(f"roofline {arch} x {shape}: {row['dominant']}-bound, "
                  f"fraction {row['roofline_frac']:.4f}, compute "
                  f"{row['compute_s']:.4e} s, memory "
                  f"{row['memory_s']:.4e} s, "
                  f"{row['mem_per_dev_gb']:.3f} GB a device, fits "
                  f"{row['fits_device']} [{card}]", flush=True)
    if any(read_counts(counters).values()):
        fail(f"the dry-run sweep launched kernels: {read_counts(counters)}")
    print(f"dry-run sweep: {len(rows)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def dryrun_phase(card, configs, counters) -> dict:
    """Phase 9: the MLA backward's scratch size as the dry run computes it
    against the library's, the three cells predicted against measured, the
    fp8-cache decode, then the sweep."""
    from repro_torch.kernels import flash_attention as fa
    scratch = fa._bwd_mla()[1]
    for b, h, skv in ((1, 128, 2048), (4, 20, 333)):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for fused in (False, True):
                if fa.mla_bwd_scratch(b, h, skv, dtype, fused) != scratch(
                        b, h, skv, code, int(fused)):
                    fail(f"mla_bwd_scratch{(b, h, skv, dtype, fused)} "
                         "differs from the library's")
    torch.cuda.empty_cache()
    cells = {f"{arch}/{kind}": dryrun_cell_check(card, configs, counters,
                                                  arch, kind, path)
             for arch, kind, path in DRYRUN_CELLS}
    fp8 = kv_fp8_decode(card, configs)
    torch.cuda.empty_cache()
    rows = dryrun_sweep(card, counters)
    return {"cells": cells, "kv_fp8_decode": fp8,
            "sweep": {f"{r['arch']}/{r['shape']}": (
                r["status"] if r["status"] != "ok" else
                [r["dominant"], round(r["roofline_frac"], 4),
                 round(r["mem_per_dev_gb"], 3), r["fits_device"]])
                for r in rows}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as configs
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch import serve, train
    from repro_torch.models import lm

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    # 1. build
    t0 = start = time.perf_counter()
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
            # the tensor-core kernels and the MLA layout's backward: no
            # spills, no serialized wgmma; the wkv6 backward's span walk,
            # the scan kernels, the MLA layout's forward and AdamW's
            # kernels: no spills
            if (("_bf16<" in row["kernel"]
                 or "flash_bwd_mla" in row["kernel"])
                    and (row["spill"] or row["c75"])):
                fail(f"{row['kernel']}: {row['spill']} bytes spilled, "
                     f"{row['c75']}")
            if (("wkv6_pair_kernel" in row["kernel"]
                 or "ssm_scan" in row["kernel"]
                 or "adamw_kernel" in row["kernel"]
                 or "norm_" in row["kernel"]
                 or "flash_fwd_mla" in row["kernel"]) and row["spill"]):
                fail(f"{row['kernel']}: {row['spill']} bytes spilled")
    t0 = phase_seconds("1 (build)", t0)

    # 2. kernels against their plain twins
    errs = check_kernels(fa, ref)
    check_mla(fa, ref, ops)
    wkv_main_err = check_wkv6(wkv)
    wkv_bwd_err = check_wkv6_bwd(wkv, ref)
    scan_errs = check_scan(ss, ref)
    t0 = phase_seconds("2 (kernels against their plain twins)", t0)

    # 3-5 for the dense main paths, TinyLlama-1.1B and Gemma-7B (hd 256)
    counters = {"flash_attention": (fa.flash_attention, "launches"),
                "flash_attention_mla": (fa.flash_attention, "launches_mla"),
                "flash_attention_bwd": (fa.flash_attention_bwd, "launches"),
                "flash_attention_bwd_mla": (fa.flash_attention_bwd,
                                            "launches_mla"),
                "wkv6": (wkv.wkv6, "launches"),
                "wkv6_bwd": (wkv.wkv6_bwd, "launches"),
                "selective_scan": (ss.selective_scan, "launches"),
                "selective_scan_bwd": (ss.selective_scan_bwd, "launches"),
                "adamw": (aw.adamw, "launches"),
                "adamw_leaves": (aw.adamw, "leaves"),
                "global_norm": (aw.global_norm, "launches")}
    launches = dense_serve(card, configs, serve, counters,
                           ARCH)["flash_attention"]

    # 4a. kernel timings at the main path's shape and at hd 256 (hd 128 at
    # Qwen3-14B's shape in 5e)
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_flash(fa, MAIN, card)
    time_flash(fa, GEMMA_B2, card)
    bwd = time_flash_bwd(fa, ref, MAIN, card)
    bwd_parts(fa, MAIN, card)

    # 4b and 5 for TinyLlama-1.1B
    serve_numbers(card, configs.get(ARCH), lm, fa)

    # 4c. the reduced model on the GPU against the CPU (non-kernel layers)
    reduced_on_gpu(card, configs, lm, ARCH)

    # 3-4 for the training main path, and C1's reduced configs
    trained = train_path(card, configs.get(ARCH), BATCH, train, counters)
    train_vs_plain(card, configs.get(ARCH), BATCH, lm)
    reduced_dense(card, configs, lm, train, counters)
    t0 = phase_seconds("3-5 (TinyLlama-1.1B served and trained)", t0)

    # 3-5 for the RWKV main path
    wkv_entry = rwkv_path(card, configs, lm, serve, wkv, counters)
    wkv_entry["max_abs_err"] = wkv_main_err
    # 3-5 for RWKV6-3B training, through the wkv6 forward (with
    # checkpoints) and backward
    wkv_bwd_entry = rwkv_train(card, configs, lm, train, wkv, ref, counters)
    wkv_bwd_entry["max_abs_err"] = wkv_bwd_err
    t0 = phase_seconds("3-5 (RWKV6-3B served and trained)", t0)

    # 3-5 for Gemma-7B (hd 256), last: the phases above run as they ran
    # before it was added, so their host-bound times stay comparable, and
    # its 17 GB of params never share the card with training's state.  4a
    # times the forward at the shape its prefill gives the kernel, and the
    # backward at the shape its training gives the kernel.  Then Gemma-7B
    # trains at full width and GEMMA_TRAIN_LAYERS deep, through the hd-256
    # forward (with lse) and backward.
    gemma_launches = dense_serve(card, configs, serve, counters,
                                 GEMMA_ARCH)["flash_attention"]
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
    t0 = phase_seconds("3-5 (Gemma-7B served and trained)", t0)

    # 5b. DeepSeek-MoE 16B and Chameleon-34B served at full width and
    # depth, each on a card with the earlier models' memory released; the
    # MoE block at full width card against CPU, the reduced MoE model too
    moe_dropped = moe_block_check(card, configs, lm)
    reduced_on_gpu(card, configs, lm, MOE_ARCH)
    # 4a at the hd-128 shapes their prefills give the kernel
    time_flash(fa, MOE_SHAPE, card)
    time_flash(fa, VLM_SHAPE, card)
    served = {arch: full_depth_serve(card, configs, lm, serve, fa, counters,
                                     arch)
              for arch in (MOE_ARCH, VLM_ARCH)}
    # C3: a MoE training step on the card leaves the router bias alone
    moe_train_step(card, configs, train)
    # A11.2: DeepSeek-MoE 16B trained at every published width,
    # MOE_TRAIN_LAYERS deep, through the hd-128 flash forward and backward
    moe_trained = moe_train(card, configs, lm, train, counters)
    # A11.3: DeepSeek-V3's MLA at its latent layout: the kernel alone beside
    # its twin and SDPA (on a card free of weights), one fp32 MLA block at
    # full width card against CPU, the reduced V3 on the GPU against the
    # CPU, then V3 served at every published width, V3_SERVE_LAYERS deep
    mla_t = time_flash_mla(fa, card)
    v3_block = v3_mla_check(card, configs, lm, fa)
    reduced_on_gpu(card, configs, lm, V3_ARCH)
    served[V3_ARCH] = v3_serve(card, configs, lm, serve, counters)
    # A11.3b: the MLA-layout backward alone beside its twin and SDPA's
    # backward, then DeepSeek-V3 trained at every published width, cut to
    # V3_TRAIN_LAYERS layers and V3_TRAIN_EXPERTS routed experts, its MTP
    # loss through the MLA-layout forward and backward
    mla_bwd_t = time_flash_mla_bwd(fa, ref, card)
    v3_trained = v3_train(card, configs, lm, train, counters)
    t0 = phase_seconds("5b (DeepSeek-MoE 16B, Chameleon-34B, DeepSeek-V3)",
                       t0)

    # 5c. Hymba-1.5B: the SSM block, the windowed
    # flash forward at 25 heads, the serve at full width and depth, then
    # its training at full width and depth (the flash backward with the
    # window, the scan's forward with checkpoints and its backward)
    served[HYMBA_ARCH], hymba_t, hymba_ssm = hymba_phase(
        card, configs, lm, serve, fa, counters)
    hymba_step, hymba_bwd, scan_t = hymba_train(card, configs, lm, train, fa,
                                                ss, ref, counters)
    t0 = phase_seconds("5c (Hymba-1.5B)", t0)

    # 5d. Whisper-small, the encoder-decoder, at every published width and
    # full depth: the flash forward and backward at its decoder's shape
    # beside SDPA, then its serve (the decoder's self-attention through the
    # flash forward; none at the published 448-token context) and its
    # training (the flash forward and backward)
    torch.cuda.empty_cache()
    whisper_t = time_flash(fa, WHISPER, card)
    whisper_bwd = time_flash_bwd(fa, ref, WHISPER, card)
    bwd_parts(fa, WHISPER, card)
    served[WHISPER_ARCH] = whisper_serve(card, configs, lm, serve, counters)
    whisper_trained = whisper_train(card, configs, lm, train, counters)
    t0 = phase_seconds("5d (Whisper-small)", t0)

    # 5e. Qwen3-14B and MiniCPM-2B: the flash forward and backward at their
    # shapes, both served at every published width and full depth,
    # MiniCPM-2B trained at full depth (its WSD schedule, its tied table),
    # Qwen3-14B at every published width cut to QWEN3_TRAIN_LAYERS
    dense5e = qwen3_minicpm_phase(card, configs, lm, serve, train, fa, ref,
                                  aw, counters)
    served.update(dense5e["served"])
    adamw_t = dense5e["kernels"]["adamw"]
    t0 = phase_seconds("5e (Qwen3-14B, MiniCPM-2B)", t0)

    # 6. the float64 DeepNVM++ pipeline, on a card with the models' memory
    # released
    torch.cuda.empty_cache()
    pipeline, mega_summary = pipeline_phase(card)
    t0 = phase_seconds("6 (the float64 pipeline)", t0)
    # 7. the sweep service and its CLI on the card
    service = service_phase(card, mega_summary)
    t0 = phase_seconds("7 (the sweep service and CLI)", t0)
    # 8. the inverse designer on the card
    inverse = inverse_phase(card)
    t0 = phase_seconds("8 (the inverse designer)", t0)
    # 9. the dry run: three cells predicted against measured, the fp8 KV
    # cache, and the sweep's roofline rows
    torch.cuda.empty_cache()
    dry = dryrun_phase(card, configs, counters)
    t0 = phase_seconds("9 (the dry run)", t0)
    print(f"chip_smoke phases: {t0 - start:.1f} s in all", flush=True)

    fwd_src = {"route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:78"}
    # no TPU kernel: the backward replaces the jnp VJP of flash_attention_ref
    bwd_src = {"route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "replaces": "src/repro/kernels/ref.py:106"}
    # no TPU kernel: the scan replaces the lax.scan of the SSM block and,
    # backward, its VJP; no PyTorch call computes either (library_ms null)
    scan_src = {"route": "cuda",
                "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
                "replaces": "src/repro/models/blocks.py:286"}
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
        # the same wrapper and source at DeepSeek-V3's MLA layout (one
        # shared k / v head, head dims 576 / 512: its own wgmma kernel in
        # bf16, the K tile read as V)
        "name": "flash_attention_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/models/blocks.py:195-200 "
                    "(ref.flash_attention_ref at the MLA layout; the Pallas "
                    "flash_attention.py:78 cannot take it)",
        "launches": served[V3_ARCH]["launches"], "max_abs_err": mla_t[5],
        "ms": mla_t[0], "plain_ms": mla_t[1], "bound_ms": mla_t[3],
        "bound_by": mla_t[4], "library_ms": mla_t[2]}, {
        # the same wrapper and source with a 1024-key window at 25 heads:
        # Hymba-1.5B's serve (its launches: 29 windowed, 3 global); the
        # library time is SDPA given the window as a boolean mask
        "name": "flash_attention_window", **fwd_src,
        "launches": served[HYMBA_ARCH]["launches"],
        "max_abs_err": errs[HYMBA_WINDOW][0], "ms": hymba_t[0],
        "plain_ms": hymba_t[1], "bound_ms": hymba_t[3],
        "bound_by": hymba_t[4], "library_ms": hymba_t[2]}, {
        # the same wrapper and source at 12 heads of 64: Whisper-small's
        # decoder (its serve at prompt 2048; the encoder and the
        # cross-attention launch none)
        "name": "flash_attention_whisper", **fwd_src,
        "launches": served[WHISPER_ARCH]["launches"],
        "max_abs_err": errs[WHISPER][0], "ms": whisper_t[0],
        "plain_ms": whisper_t[1], "bound_ms": whisper_t[3],
        "bound_by": whisper_t[4], "library_ms": whisper_t[2]}, *[{
        # the same wrapper and source at Qwen3-14B's 40 heads of 128 (GQA
        # expanded before the call) and MiniCPM-2B's 36 heads of 64: their
        # serves
        "name": f"flash_attention_{label}", **fwd_src,
        "launches": served[arch]["launches"],
        "max_abs_err": dense5e["kernels"][arch]["errs"][0],
        **timing(dense5e["kernels"][arch]["fwd"])}
        for label, arch in (("qwen3", QWEN3_ARCH),
                            ("minicpm", MINICPM_ARCH))], {
        "name": "flash_attention_bwd", **bwd_src,
        "launches": trained["launches"]["flash_attention_bwd"],
        "max_abs_err": errs[MAIN][1], "ms": bwd[0], "plain_ms": bwd[1],
        "bound_ms": bwd[3], "bound_by": bwd[4], "library_ms": bwd[2]}, {
        # the same wrapper and source at head dim 256: Gemma-7B's training
        "name": "flash_attention_bwd_hd256", **bwd_src,
        "launches": gemma_trained["launches"]["flash_attention_bwd"],
        "max_abs_err": errs[GEMMA_B2][1], "ms": gemma_bwd[0],
        "plain_ms": gemma_bwd[1], "bound_ms": gemma_bwd[3],
        "bound_by": gemma_bwd[4], "library_ms": gemma_bwd[2]}, {
        # the same wrapper and source with the 1024-key window: Hymba-1.5B's
        # training (its launches: 29 windowed, 3 global)
        "name": "flash_attention_bwd_window", **bwd_src,
        "launches": hymba_step["flash_attention_bwd"],
        "max_abs_err": errs[HYMBA_WINDOW][1], "ms": hymba_bwd[0],
        "plain_ms": hymba_bwd[1], "bound_ms": hymba_bwd[3],
        "bound_by": hymba_bwd[4], "library_ms": hymba_bwd[2]}, {
        # the same wrapper and source at 12 heads of 64: Whisper-small's
        # training (its decoder layers)
        "name": "flash_attention_bwd_whisper", **bwd_src,
        "launches": whisper_trained["launches"]["flash_attention_bwd"],
        "max_abs_err": errs[WHISPER][1], "ms": whisper_bwd[0],
        "plain_ms": whisper_bwd[1], "bound_ms": whisper_bwd[3],
        "bound_by": whisper_bwd[4], "library_ms": whisper_bwd[2]}, *[{
        # the same wrapper and source at Qwen3-14B's and MiniCPM-2B's
        # training shapes (Qwen3-14B at its depth cut)
        "name": f"flash_attention_bwd_{label}", **bwd_src,
        "launches": dense5e["trained"][arch]["launches"][
            "flash_attention_bwd"],
        "max_abs_err": dense5e["kernels"][arch]["errs"][1],
        **timing(dense5e["kernels"][arch]["bwd"])}
        for label, arch in (("qwen3", QWEN3_ARCH),
                            ("minicpm", MINICPM_ARCH))], {
        # the same wrapper and source at DeepSeek-V3's MLA layout (its own
        # wgmma kernels in bf16, dK and dV summed over the heads and dV
        # into dK, as the main path calls it): V3's training at MLA_TRAIN;
        # the library time is SDPA's backward with k and v expanded to 128
        # heads
        "name": "flash_attention_bwd_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:106 (the jnp VJP of "
                    "flash_attention_ref at the MLA layout, "
                    "src/repro/models/blocks.py:195-200)",
        "launches": v3_trained["launches"]["flash_attention_bwd_mla"],
        "max_abs_err": mla_bwd_t[MLA_TRAIN][5], "ms": mla_bwd_t[MLA_TRAIN][0],
        "plain_ms": mla_bwd_t[MLA_TRAIN][1],
        "bound_ms": mla_bwd_t[MLA_TRAIN][3],
        "bound_by": mla_bwd_t[MLA_TRAIN][4],
        "library_ms": mla_bwd_t[MLA_TRAIN][2]},
        wkv_entry, wkv_bwd_entry, {
        "name": "selective_scan", **scan_src,
        "launches": served[HYMBA_ARCH]["scan_launches"],
        "max_abs_err": scan_errs[0], "ms": scan_t["forward"][0],
        "plain_ms": scan_t["forward"][1], "bound_ms": scan_t["forward"][2],
        "bound_by": scan_t["forward"][3], "library_ms": None}, {
        "name": "selective_scan_bwd", **scan_src,
        "launches": hymba_step["selective_scan_bwd"],
        "max_abs_err": scan_errs[1], "ms": scan_t["backward"][0],
        "plain_ms": scan_t["backward"][1], "bound_ms": scan_t["backward"][2],
        "bound_by": scan_t["backward"][3], "library_ms": None}, {
        # no TPU kernel: XLA fuses the JAX update; the update kernel with
        # its clip norm at MiniCPM-2B's leaves, launches a MiniCPM-2B step;
        # the library time is clip_grad_norm_ + AdamW(fused=True)
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "src/repro/optim/optimizer.py:69",
        "launches": dense5e["trained"][MINICPM_ARCH]["launches"]["adamw"],
        "max_abs_err": adamw_t["max_abs_err"], "ms": adamw_t["ms"],
        "plain_ms": adamw_t["plain_ms"], "bound_ms": adamw_t["bound_ms"],
        "bound_by": "bytes", "library_ms": adamw_t["library_ms"]}, {
        # the norm alone (the metrics' second norm a step); the library
        # time is torch._foreach_norm's
        "name": "global_norm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "src/repro/optim/optimizer.py:51",
        "launches": dense5e["trained"][MINICPM_ARCH]["launches"][
            "global_norm"],
        "max_abs_err": adamw_t["norm_err"], "ms": adamw_t["norm_ms"],
        "plain_ms": adamw_t["plain_norm_ms"],
        "bound_ms": adamw_t["norm_bound_ms"], "bound_by": "bytes",
        "library_ms": adamw_t["library_norm_ms"]}]}))
    print(json.dumps({"served": served, "moe_dropped_slots": moe_dropped,
                      "hymba_ssm_block": hymba_ssm,
                      "moe_train": {k: moe_trained[k] for k in (
                          "step_ms", "tokens_per_s", "peak_gb", "launches",
                          "losses")},
                      "v3_train": {k: v3_trained[k] for k in (
                          "step_ms", "tokens_per_s", "peak_gb", "launches",
                          "losses", "params_b")},
                      "whisper_train": {k: whisper_trained[k] for k in (
                          "step_ms", "tokens_per_s", "peak_gb", "launches",
                          "losses", "params_b")},
                      **{f"{label}_train": {k: dense5e["trained"][arch][k]
                                            for k in (
                          "step_ms", "tokens_per_s", "peak_gb", "launches",
                          "losses", "params_b", "schedule", "lrs")}
                         for label, arch in (("qwen3", QWEN3_ARCH),
                                             ("minicpm", MINICPM_ARCH))},
                      "v3_mla_block": v3_block}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"service": service}))
    print(json.dumps({"inverse": inverse}))
    print(json.dumps({"dryrun": dry}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
