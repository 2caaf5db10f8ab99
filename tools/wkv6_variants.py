#!/usr/bin/env python3
"""Time configurations of the wkv6 kernel against each other, on one GPU.

    python3 tools/wkv6_variants.py [ROWS,COLS,VT,MINB,STAGES ...]

Builds `src/repro_torch/kernels/csrc/wkv6.cu` once per hd-64 configuration
(ROWS state rows and COLS state columns a thread, VT columns a block, MINB
blocks an SM must hold: the source's `Pick<64>` line; STAGES in the
staging ring: its `kStages` line; default: the configurations in CONFIGS,
the shipped one first), each a text edit of the source, one nvcc per
configuration, all started together, and prints ptxas's register and spill
lines for each.  Then, at the serving path's prefill shape
(4, 2048, 40, 64) fp32 with s0, each configuration is held against the
plain twin (chip_smoke's bar) and timed at chunk 16 and chunk 32 with CUDA
events (20 launches after a warm-up), and at the decode shape
(4, 1, 40, 64) with s0 by the profiler's device time (50 launches): three
rounds, each taking every configuration in turn.  Each line gives the three
times and the bound.  Needs nvcc and a CUDA device.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

SRC = (build.CSRC / "wkv6.cu").read_text()
OUT = build.BUILD_DIR / "variants"
CONFIGS = [(4, 4, 32, 3, 2),                       # shipped
           (8, 1, 32, 3, 2), (8, 1, 16, 6, 2), (16, 1, 32, 3, 2),
           (8, 2, 32, 3, 2), (8, 4, 32, 3, 2), (4, 4, 32, 3, 3),
           (4, 4, 16, 5, 2)]
PREFILL = cs.WKV_MAIN
DECODE = cs.WKV_DECODE
CHUNKS = (16, 32)
ROUNDS = 3


def edit(src: str, pattern: str, repl: str) -> str:
    """Replace the one match of `pattern` (a regex) by `repl`."""
    out, n = re.subn(pattern, repl, src)
    if n != 1:
        raise ValueError(f"{n} matches of {pattern!r}, want 1: the kernel "
                         "source changed; update the edit")
    return out


def variant(rows: int, cols: int, vt: int, minb: int, stages: int) -> str:
    src = edit(SRC, r"using T = Cfg<64, \d+, \d+, \d+, \d+>;",
               f"using T = Cfg<64, {rows}, {cols}, {vt}, {minb}>;")
    return edit(src, r"constexpr int kStages = \d+;",
                f"constexpr int kStages = {stages};")


def compile_all(configs) -> dict:
    """config -> bound (wkv6_fwd, wkv6_error_string)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cfg in configs:
        name = "wkv6_" + "_".join(map(str, cfg))
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(variant(*cfg))
        procs[cfg] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cfg, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {cfg}:\n{log}")
        entry = ""   # ptxas names the function, then reports on it
        for line in log.splitlines():
            if "entry function" in line or "properties for" in line:
                entry = line
            elif "CfgILi64E" in entry and any(
                    w in line for w in ("registers", "spill", "arning")):
                print(f"  {cfg} hd 64: {line.strip()}")
        libs[cfg] = wkv.bind(ctypes.CDLL(str(so)))
    return libs


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("wkv6_variants: no CUDA device", file=sys.stderr)
        return 1
    configs = ([tuple(int(x) for x in a.split(",")) for a in argv]
               or CONFIGS)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = compile_all(configs)
    pre, dec = cs.wkv_inputs(PREFILL), cs.wkv_inputs(DECODE)
    want = wkv.wkv6_plain(*pre)
    runs = [(cfg, name, args, chunk) for cfg in libs
            for name, args, chunks in (("prefill", pre, CHUNKS),
                                       ("decode", dec, (32,)))
            for chunk in chunks]
    for cfg, fwd in libs.items():
        for chunk in CHUNKS:
            got = wkv.launch(fwd, *pre, chunk)
            torch.cuda.synchronize()
            oks = [cs.wkv_ok(g, w) for g, w in zip(got, want)]
            print(f"{cfg} chunk {chunk}: max abs err y {oks[0][1]:.3e}, "
                  f"state {oks[1][1]:.3e}", flush=True)
            if not all(ok for ok, _ in oks):
                raise SystemExit(f"wkv6_variants: {cfg} chunk {chunk} "
                                 "misses the bar")
    del want
    times = {run[:2] + (run[3],): [] for run in runs}
    for _ in range(ROUNDS):
        for cfg, name, args, chunk in runs:
            fwd = libs[cfg]

            def call():
                return wkv.launch(fwd, *args, chunk)
            # a decode launch is shorter than the host's work around it:
            # its device time comes from the profiler
            times[(cfg, name, chunk)].append(
                cs.time_ms(call, 20) if name == "prefill"
                else cs.kernel_device_ms(call, "wkv6_kernel"))
    for (cfg, name, chunk), ts in times.items():
        bound_ms, bound_by = cs.wkv_bound(PREFILL if name == "prefill"
                                          else DECODE)
        print(f"rows,cols,vt,minb,stages {cfg} {name} chunk {chunk}: "
              + ", ".join("not measured" if t is None else f"{t:.4f}"
                          for t in ts)
              + f" ms; bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
