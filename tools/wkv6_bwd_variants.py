#!/usr/bin/env python3
"""Time configurations of the wkv6 backward against each other, on one GPU.

    python3 tools/wkv6_bwd_variants.py [--other PATH ...] [RB,MINB ...]

Builds `src/repro_torch/kernels/csrc/wkv6.cu` once per hd-64 configuration
of its span walk by token pairs (`wkv6_pair_kernel`: RB rows a block, one
thread a row, MINB blocks an SM must hold; the `PPick<64>` line), each a
text edit of the source (default: CONFIGS, the shipped one first), and,
given `--other` (once or more), other `wkv6.cu` files as they are (an earlier
design, e.g. one kept under the git-ignored `runs/`; its `wkv6_bwd` may
take the earlier C interface without the `gck` scratch).  One nvcc per
build, all started together; prints ptxas's register and spill lines of
each build's hd-64 backward kernels.  Then, at the training shape
(4, 2048, 40, 64) fp32 without s0 or ds_final, each build's backward is
held against the plain twin (chip_smoke's bar, WKV_BWD_BAR) and timed with
CUDA events (20 calls after a warm-up), and so is its forward with
checkpoints and serving's forward: three rounds, each taking every build
in turn.  Each line gives the three times and the bound; then each
build's backward by launch (profiler device time, 10 calls).  Needs nvcc
and a CUDA device.
"""

from __future__ import annotations

import argparse
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
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

SRC = (build.CSRC / "wkv6.cu").read_text()
OUT = build.BUILD_DIR / "bwd_variants"
CONFIGS = [(64, 4), (64, 3), (32, 8)]                # shipped first
SHAPE = cs.WKV_MAIN[:4] + (32, -3.0, False, 0)   # as training calls it
ROUNDS = 3


def edit(src: str, pattern: str, repl: str) -> str:
    """Replace the one match of `pattern` (a regex) by `repl`."""
    out, n = re.subn(pattern, repl, src)
    if n != 1:
        raise ValueError(f"{n} matches of {pattern!r}, want 1: the kernel "
                         "source changed; update the edit")
    return out


def variant(rb: int, minb: int) -> str:
    return edit(SRC, r"using T = PCfg<64, \d+, \d+>;",
                f"using T = PCfg<64, {rb}, {minb}>;")


def bind_any(lib: ctypes.CDLL, src: str):
    """(bwd, fwd, new_api) of a built wkv6.cu: its backward takes the gck
    scratch (this design) or not (the earlier one)."""
    new_api = re.search(r"int wkv6_bwd\([^)]*\bgck\b", src) is not None
    if new_api:
        return wkv.bind_bwd(lib), wkv.bind(lib), True
    fn = lib.wkv6_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return (fn, wkv.bind(lib)[1]), wkv.bind(lib), False


def call_old(bwd, r, k, v, w, u, dy, ck):
    """The earlier interface's backward (no s0, no ds_final):
    (dr, dk, dv, dw, du, ds0)."""
    b, s, h, hd = r.shape

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (new(b, s, h, hd) for _ in range(4))
    du, ds0, du_part = new(h, hd), new(b, h, hd, hd), new(b, h, hd)
    strides = (ctypes.c_longlong * 21)(*(
        st for t in (r, k, v, w, dy, dr, dv) for st in t.stride()[:3]))
    fn, errstr = bwd
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), dy.data_ptr(), ck.data_ptr(), None,
             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
             du.data_ptr(), ds0.data_ptr(), du_part.data_ptr(), b, s, h, hd,
             strides, 32, int(wkv.copy_bytes(r, k, v, w, dy) == 16),
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_bwd failed: {errstr(err).decode()}")
    return dr, dk, dv, dw, du, ds0


def compile_all(builds: dict) -> dict:
    """name -> source text; returns name -> (bwd, fwd, new_api)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for x, (name, src) in enumerate(builds.items()):
        cu, so = OUT / f"wkv6_{x}.cu", OUT / f"wkv6_{x}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for row in cs.ptxas_report(log):
            if ("wkv6_pair" in row["kernel"] or "wkv6_bwd" in row["kernel"]
                    or "wkv6_rev" in row["kernel"]
                    or "wkv6_kernel" in row["kernel"]) \
                    and row["kernel"].split("<")[1].startswith("64"):
                print(f"  {name}: {row['kernel']}: {row['registers']} "
                      f"registers, {row['spill']} bytes spill stores",
                      flush=True)
        libs[name] = bind_any(ctypes.CDLL(str(so)), builds[name])
    return libs


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another wkv6.cu to time (repeatable)")
    ap.add_argument("configs", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    configs = ([tuple(int(x) for x in a.split(",")) for a in args.configs]
               or CONFIGS)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    builds = {"rb,minb=" + ",".join(map(str, c)): variant(*c)
              for c in configs}
    for other in args.other:
        builds[f"other={other}"] = other.read_text()
    libs = compile_all(builds)
    r, k, v, w, u, _, dy, _ = cs.wkv_bwd_inputs(SHAPE)
    _, _, ck = wkv.wkv6_fwd(r, k, v, w, u, want_ckpt=True)
    want = ref.wkv6_bwd_plain(r, k, v, w, u, None, dy, None,
                              ckpt_every=wkv.CKPT_EVERY)
    calls = {}
    for name, (bwd, fwd, new_api) in libs.items():
        if new_api:
            def call(bwd=bwd):
                return wkv.bwd_launch(bwd, r, k, v, w, u, None, dy, None,
                                      ck)[:6]
        else:
            def call(bwd=bwd):
                return call_old(bwd, r, k, v, w, u, dy, ck)
        got = call()
        torch.cuda.synchronize()
        errs = {n: (a - b).abs().max().item() for n, a, b in zip(
            ("dr", "dk", "dv", "dw", "du"), got, want)}
        ok = all(err <= 1e-4 * max(b.abs().max().item(), 1.0)
                 and torch.isfinite(a).all().item()
                 for err, a, b in zip(errs.values(), got, want))
        print(f"{name}: max abs err {errs} ({cs.WKV_BWD_BAR}: "
              f"{'held' if ok else 'MISSED'})", flush=True)
        if not ok:
            raise SystemExit(f"wkv6_bwd_variants: {name} misses the bar")
        calls[name] = (call,
                       lambda fwd=fwd: wkv.launch(fwd, r, k, v, w, u, None,
                                                  32, ck),
                       lambda fwd=fwd: wkv.launch(fwd, r, k, v, w, u, None,
                                                  32))
    del want
    times = {name: ([], [], []) for name in calls}
    for _ in range(ROUNDS):
        for name, fns in calls.items():
            for ts, fn in zip(times[name], fns):
                ts.append(cs.time_ms(fn, 20))
    bound_ms, bound_by = cs.wkv_bwd_bound(SHAPE, wkv.CKPT_EVERY)
    ck_bound = cs.wkv_bound(SHAPE, wkv.CKPT_EVERY)

    def fmt(ts):
        return ", ".join(f"{t:.4f}" for t in ts)
    for name, (tb, tc, tf) in times.items():
        print(f"{name}: backward {fmt(tb)} ms (bound {bound_ms:.4f}, "
              f"{bound_by}); forward with checkpoints {fmt(tc)} ms (bound "
              f"{ck_bound[0]:.4f}, {ck_bound[1]}); serving's forward "
              f"{fmt(tf)} ms [{card}]", flush=True)
    for name, (bwd_call, _, _) in calls.items():
        rows = cs.device_kernels(lambda: [bwd_call() and None
                                          for _ in range(10)])
        print(f"{name}: per launch (profiler) " + ", ".join(
            f"{re.search(r'wkv6_[a-z_]*kernel(<[^>]*>)?', e.key)[0]} "
            f"{e.self_device_time_total / 1e4:.4f} ms"
            for e in rows if "wkv6" in e.key), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
