#!/usr/bin/env python3
"""Time builds and chunk lengths of the selective-scan kernels against each
other, on one GPU.

    python3 tools/scan_variants.py [--other PATH ...] [--ablate PATH ...]
                                   [--chunk C ...]

Builds `src/repro_torch/kernels/csrc/selective_scan.cu` as it is and, given
`--other` (once or more), other `selective_scan.cu` files as they are (an
earlier design, e.g. one kept under the git-ignored `runs/` by `git show
<commit>:src/repro_torch/kernels/csrc/selective_scan.cu`; it may take the
earlier C interface, without chunks, with checkpoints every 32 tokens and
32 channels a block), and given `--ablate`, sources edited to take a part
out (timed and their errors printed, but not held to the bar).  One nvcc
per build, all started together; prints
ptxas's register and spill lines of each build's scan kernels.  The shipped
build runs once per `--chunk` (tokens a chunk, a multiple of CKPT_EVERY;
default the wrapper's CHUNK).  Then, at chip_smoke's SCAN_MAIN (Hymba-1.5B's
(4, 2048, 1600, 16) fp32 without h0, as training calls it), each run's
forward (y, h_last) and backward (ddt, du, dB, dC, da, dh0) are held against
the plain twins with chip_smoke's bars (SCAN_FWD_BAR, SCAN_BWD_BAR), and
serving's forward, the forward with checkpoints and the backward are timed
with CUDA events (20 calls after a warm-up) in three rounds, each taking
every run in turn.  Each line gives the three times and the bounds; then
each run's calls by launch (profiler device time, 10 calls).  Needs nvcc
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
from repro_torch.kernels import selective_scan as ss  # noqa: E402

SRC = build.CSRC / "selective_scan.cu"
OUT = build.BUILD_DIR / "scan_variants"
ROUNDS = 3
# the earlier interface (PR 27's): no chunk, h every 32 tokens, 32
# channels a block
OLD_CKPT_EVERY, OLD_CHANNELS = 32, 32


def new_api(src: str) -> bool:
    return re.search(r"int ssm_scan_fwd\([^)]*\bchunk\b", src) is not None


def compile_all(builds: dict) -> dict:
    """name -> source text; returns name -> ctypes.CDLL."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for x, (name, src) in enumerate(builds.items()):
        cu, so = OUT / f"scan_{x}.cu", OUT / f"scan_{x}.so"
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
            if "ssm_scan" in row["kernel"]:
                print(f"  {name}: {row['kernel']}: {row['registers']} "
                      f"registers, {row['spill']} bytes spill stores",
                      flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def old_calls(lib: ctypes.CDLL, args, dy):
    """(serving's forward, forward with checkpoints, backward) through the
    earlier interface."""
    fwd_fn, errstr = lib.ssm_scan_fwd, lib.ssm_scan_error_string
    fwd_fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fwd_fn.restype = ctypes.c_int
    errstr.argtypes, errstr.restype = [ctypes.c_int], ctypes.c_char_p
    bwd_fn = lib.ssm_scan_bwd
    bwd_fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    bwd_fn.restype = ctypes.c_int
    dt, u, b, c, a, h0 = args
    bsz, s, di = dt.shape
    n = a.shape[-1]
    nck = -(-s // OLD_CKPT_EVERY)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dt.device)

    def stream():
        return torch.cuda.current_stream(dt.device).cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"selective_scan (other) failed: "
                               f"{errstr(err).decode()}")

    def fwd(want_ckpt=False):
        y, hl = new(bsz, s, di), new(bsz, di, n)
        ck = new(bsz, nck, di, n) if want_ckpt else None
        check(fwd_fn(dt.data_ptr(), u.data_ptr(), b.data_ptr(), c.data_ptr(),
                     a.data_ptr(), None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), hl.data_ptr(),
                     None if ck is None else ck.data_ptr(), bsz, s, di, n,
                     stream()))
        return y, hl, ck
    ck = fwd(True)[2]

    def bwd():
        ddt, du = new(bsz, s, di), new(bsz, s, di)
        db, dc = new(bsz, s, n), new(bsz, s, n)
        da, dh0 = new(di, n), new(bsz, di, n)
        nblk = -(-di // OLD_CHANNELS)
        pb, pc, dap = (new(nblk, bsz, s, n), new(nblk, bsz, s, n),
                       new(bsz, di, n))
        check(bwd_fn(dt.data_ptr(), u.data_ptr(), b.data_ptr(), c.data_ptr(),
                     a.data_ptr(), dy.data_ptr(), None, ck.data_ptr(),
                     ddt.data_ptr(), du.data_ptr(), db.data_ptr(),
                     dc.data_ptr(), da.data_ptr(), dh0.data_ptr(),
                     pb.data_ptr(), pc.data_ptr(), dap.data_ptr(), bsz, s,
                     di, n, stream()))
        return ddt, du, db, dc, da, dh0
    return (lambda: fwd()[:2]), (lambda: fwd(True)), bwd


def new_calls(lib: ctypes.CDLL, args, dy, chunk: int):
    """(serving's forward, forward with checkpoints, backward) through this
    design's interface at `chunk` tokens a chunk."""
    fwd, bwd = ss.bind(lib), ss.bind_bwd(lib)
    ck = ss.launch(fwd, *args, True, chunk)[2]
    return ((lambda: ss.launch(fwd, *args, False, chunk)[:2]),
            (lambda: ss.launch(fwd, *args, True, chunk)),
            (lambda: ss.bwd_launch(bwd, *args, dy, None, ck, chunk)))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another selective_scan.cu to time (repeatable)")
    ap.add_argument("--ablate", type=Path, action="append", default=[],
                    help="an edited selective_scan.cu, timed but not held "
                    "to the bar (repeatable)")
    ap.add_argument("--chunk", type=int, action="append", default=[],
                    help="tokens a chunk for the shipped build (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    builds = {"shipped": SRC.read_text()}
    for other in args.other:
        builds[f"other={other}"] = other.read_text()
    for other in args.ablate:
        builds[f"ablate={other}"] = other.read_text()
    libs = compile_all(builds)
    scan_args, dy, _ = cs.scan_inputs(cs.SCAN_MAIN)
    want_y, want_h = ss.ssm_scan_plain(*scan_args)
    want = ref.ssm_scan_bwd_plain(*scan_args, dy, None,
                                  ckpt_every=ss.CKPT_EVERY)
    runs = {}
    for name, lib in libs.items():
        if not new_api(builds[name]):
            runs[name] = old_calls(lib, scan_args, dy)
            continue
        for chunk in (args.chunk or [ss.CHUNK]) if name == "shipped" else [
                ss.CHUNK]:
            runs[f"{name} chunk={chunk}"] = new_calls(lib, scan_args, dy,
                                                      chunk)
    for name, (serve, _, bwd) in runs.items():
        y, h = serve()
        got = bwd()
        torch.cuda.synchronize()
        fwd_err = {"y": cs.rel_err(y, want_y), "h_last": cs.rel_err(h, want_h)}
        errs = {k: (g - w).abs().max().item() for k, g, w in zip(
            ("ddt", "du", "db", "dc", "da", "dh0"), got, want)}
        ok = max(fwd_err.values()) <= cs.SCAN_FWD_BAR and all(
            err <= 1e-4 * max(w.abs().max().item(), 1.0)
            and torch.isfinite(g).all().item()
            for err, g, w in zip(errs.values(), got, want))
        print(f"{name}: forward rel err {fwd_err} (bar {cs.SCAN_FWD_BAR}), "
              f"backward max abs err {errs} ({cs.SCAN_BWD_BAR}): "
              f"{'held' if ok else 'MISSED'}", flush=True)
        if not ok and not name.startswith("ablate="):
            raise SystemExit(f"scan_variants: {name} misses the bar")
    del want, want_y, want_h
    times = {name: ([], [], []) for name in runs}
    for _ in range(ROUNDS):
        for name, fns in runs.items():
            for ts, fn in zip(times[name], fns):
                ts.append(cs.time_ms(fn, 20))
    fwd_b = cs.scan_bound(cs.SCAN_MAIN)
    ck_b = cs.scan_bound(cs.SCAN_MAIN, ckpt=True)
    bwd_b = cs.scan_bound(cs.SCAN_MAIN, backward=True)

    def fmt(ts):
        return ", ".join(f"{t:.4f}" for t in ts)
    for name, (tf, tc, tb) in times.items():
        print(f"{name}: forward {fmt(tf)} ms (bound {fwd_b[0]:.4f}, "
              f"{fwd_b[1]}); with checkpoints {fmt(tc)} ms (bound "
              f"{ck_b[0]:.4f}, {ck_b[1]}); backward {fmt(tb)} ms (bound "
              f"{bwd_b[0]:.4f}, {bwd_b[1]}) [{card}]", flush=True)
    for name, (serve, ckpt, bwd) in runs.items():
        for label, fn in (("forward", serve), ("with checkpoints", ckpt),
                          ("backward", bwd)):
            print(f"{name}: {label} by launch (profiler) "
                  f"{cs.scan_launches(fn)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
