#!/usr/bin/env python3
"""Where the bf16 MLA-layout flash kernel spends its time, on one GPU.

    python3 tools/mla_ablation.py [VARIANT ...]

Builds variants of `src/repro_torch/kernels/csrc/flash_attention.cu`, each
with one part of `flash_fwd_mla_bf16` taken out by a text edit of the
source (the other kernels are kept as they are), prints ptxas's registers
and spills for each, and times each at DeepSeek-V3's prefill shape (4, 2048
into 2064 keys, 128 heads, 576 / 512, v a view of k), bf16, causal, with
CUDA events (three runs of 10 launches after a warm-up).  Only `kernel`
computes the right answer; its max abs error against the plain twin is
printed.  The variants:

  kernel       the source as it is
  no_softmax   P = S rounded to bf16, own high half only: no scaling,
               masking, max, exponentials, sums, split, exchange or barriers
  no_barrier   the softmax's four barriers a tile taken out (the row max
               and P then race between the warpgroups)
  no_exp2      2^x replaced by one FMA (the SFUs idle)
  high_only    P V with P's bf16 high part alone (half the P V products,
               P rounded to bf16 as the hd 64-256 kernels have it)
  gemm_only    no_softmax, and no K tile loaded past the first two: the
               products on stale tiles, no L2 traffic in the loop
  half_k       the K tiles past the first two load 5 of their 9 boxes
               (the rest stale): the loop's L2 traffic nearly halved, as
               two blocks sharing each tile would halve it
  double       every block walks its key tiles twice: the extra time over
               `kernel` is the tiles' own, the rest of `kernel`'s time is
               fixed cost per block (Q's load, the first tiles, the store)

An edit whose anchor is missing from the source raises: the source has
changed and the variant must follow it.  Needs nvcc and a CUDA device.
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

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SRC = (build.CSRC / "flash_attention.cu").read_text()
OUT = build.BUILD_DIR / "mla_ablation"
# the MLA wgmma kernel's region of the source: the edits reach only it
BEGIN, END = "namespace mla_tc {", "int launch_mla("
SHAPE = (4, 2048, 2064, 128)   # (B, Sq, Skv, H)
SCALE = 192 ** -0.5            # V3's qk_dim ** -0.5
PACK = ("corr[0] = corr[1] = 1.f;\n"
        "      for (int i = 0; i < 8; ++i)\n"
        "        ph[2 * WG + i / 4][i % 4] = pack_bf16(s[2 * i], s[2 * i + 1]);")


def edit(src: str, pattern: str, repl: str, count: int) -> str:
    """Replace `pattern` (a regex) by `repl`, expecting `count` matches."""
    out, n = re.subn(pattern, repl, src)
    if n != count:
        raise ValueError(f"{n} matches of {pattern!r}, want {count}: the "
                         "kernel source changed; update the variant")
    return out


def variants() -> dict[str, str]:
    lit = re.escape
    a, b = SRC.index(BEGIN), SRC.index(END)
    head, mla, tail = SRC[:a], SRC[a:b], SRC[b:]
    no_softmax = edit(mla, r"softmax\(s, (0|it)\);", PACK.replace("\\", r"\\"),
                      2)
    no_barrier = edit(mla, r"\n    bar_sync\(1\);  // both [^\n]*", "", 4)
    no_exp2 = edit(mla, lit("s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);"),
                   "s[i] = fmaf(s[i] - m[(i >> 1) & 1], 0.0625f, 1.f);", 1)
    gemm_only = edit(no_softmax, lit("it + C::kKStages < n_tiles && lane == 0"),
                     "false", 1)
    gemm_only = edit(gemm_only, r"\n      mbar_wait\(base \+ C::kKFull \+ 8 \*"
                                r"[^;]*;", "", 1)
    high_only = edit(mla, lit("    wgmma_rs(o, pl[kk], dv);\n"), "", 1)
    half_k = edit(mla, lit("load_rows<kQKBoxes>(tk, k_tile(it)"),
                  "load_rows<5>(tk, k_tile(it)", 1)
    double = edit(mla, lit("const int n_tiles = max(hi - lo, 0);"),
                  "const int n_tiles = 2 * max(hi - lo, 0);", 1)
    double = edit(double, r"\(lo \+ ([^()]*(\([^()]*\))?[^()]*)\) \* kBN",
                  r"(lo + (\1) % (n_tiles / 2)) * kBN", 4)
    return {name: head + body + tail for name, body in [
        ("kernel", mla), ("no_softmax", no_softmax),
        ("no_barrier", no_barrier), ("no_exp2", no_exp2),
        ("high_only", high_only),
        ("gemm_only", gemm_only), ("half_k", half_k), ("double", double)]}


def compile_all(sources: dict[str, str]) -> dict[str, object]:
    """One nvcc per variant, all started together; prints each build's
    registers and spills for the MLA kernels and its C75xx lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        notes = [ln.strip() for ln in lines if "C75" in ln]
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "flash_fwd_mla_bf16" in ln:
                kind = "shared_kv" if "ILb1E" in ln else "own_v"
                notes += [f"{kind}: " + "; ".join(
                    x.strip() for x in lines[i + 1:i + 5]
                    if "spill" in x or "registers" in x)]
        print(f"built {name}: " + " | ".join(notes), flush=True)
        libs[name] = fa.bind_mla(ctypes.CDLL(str(OUT / f"{name}.so")))[0]
    return libs


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mla_ablation: no CUDA device", file=sys.stderr)
        return 1
    sources = variants()
    libs = compile_all({n: sources[n] for n in names or sources})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    b, sq, skv, h = SHAPE
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(b, sq, h, 576, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, skv, 1, 576, generator=g, device="cuda").bfloat16()
    v = k[..., :512]
    kw = dict(causal=True, scale=SCALE)
    with torch.no_grad():
        want = fa.flash_attention_plain(q, k, v, **kw)
    out = torch.empty(b, sq, h, 512, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in libs.items():
        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None, 1, 1, b, h, sq, skv, *q.stride()[:3],
                     *k.stride()[:2], *v.stride()[:2], *out.stride()[:3],
                     1, 0, 0, SCALE, stream)
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(3):
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        err = (out.float() - want.float()).abs().max().item()
        print(f"{SHAPE} {name:11s} ms " + " ".join(f"{t:.4f}" for t in times)
              + (f" max_abs_err {err:.4g}" if name == "kernel" else "")
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
