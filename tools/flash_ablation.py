#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel spends its time, on one GPU.

    python3 tools/flash_ablation.py [VARIANT ...]

Builds variants of `src/repro_torch/kernels/csrc/flash_attention.cu`, each
with one part of the kernel taken out by a text edit of the source, and times
each at the serving path's shape (4, 2048, 32, 64), at hd 128
(4, 2048, 40, 128) and at Gemma-7B's hd 256 (2, 2048, 16, 256), bf16,
causal, with CUDA events (three runs of 20 launches after a warm-up).
Only `kernel` computes the right answer; its max abs error against the
plain twin is printed.  The variants:

  kernel       the source as it is
  no_softmax   P = S: no scaling, masking, max, exponentials or sums
  gemm_only    no_softmax, and no K/V loads (nor, at hd 256, the
               consumers' refills): the products on stale tiles
  no_pingpong  the warpgroups issue their products without taking turns
  no_exp2      2^x replaced by one FMA (the SFUs idle)
  double       every block walks its KV tiles twice: the extra time over
               `kernel` is the tiles' own, the rest of `kernel`'s time is
               fixed cost per block (launch, barriers, Q, the last P V,
               the store)

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
# The edits reach only the bf16 kernel at hd 64 / 128 / 256, which ends
# where the SIMT kernels begin; the rest of the source is kept as it is.
TAIL_MARK = "// SIMT kernel: fp32 at every head dim"
OUT = build.BUILD_DIR / "ablation"
SHAPES = [(4, 2048, 32, 64), (4, 2048, 40, 128), (2, 2048, 16, 256)]
REFILL = "it + C::kStages < n_tiles && lane == 0"   # hd 256's consumers
PRODUCER_LOOP = ("  for (int it = 0; it < n_tiles; ++it) {\n"
                 "    const int st = it % C::kStages, k0 = (lo + it) * C::kBK;")


def edit(src: str, pattern: str, repl: str, count: int) -> str:
    """Replace `pattern` (a regex) by `repl`, expecting `count` matches."""
    out, n = re.subn(pattern, repl, src)
    if n != count:
        raise ValueError(f"{n} matches of {pattern!r}, want {count}: the "
                         "kernel source changed; update the variant")
    return out


def variants() -> dict[str, str]:
    lit = re.escape
    cut = SRC.index(TAIL_MARK)
    head, tail = SRC[:cut], SRC[cut:]
    no_softmax = edit(head, r"softmax\(s, m, l, corr, [^;]*\);",
                      "corr[0] = corr[1] = 1.f;", 2)
    gemm_only = edit(no_softmax, lit(PRODUCER_LOOP),
                     PRODUCER_LOOP.replace("it < n_tiles", "it < 0"), 1)
    gemm_only = edit(gemm_only, r"\n\s*mbar_wait\(base \+ C::k[KV]Full[^\n]*",
                     "", 4)
    gemm_only = edit(gemm_only, lit(REFILL), "false", 1)
    no_pingpong = edit(head, r"\n\s*(if \([^\n]*\) )?bar_(sync|arrive)\([^\n]*",
                       "", 5)
    no_exp2 = edit(head, lit("s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);"),
                   "s[i] = fmaf(s[i] - m[(i >> 1) & 1], 0.0625f, 1.f);", 1)
    double = edit(head, lit(PRODUCER_LOOP), PRODUCER_LOOP.replace(
        "it < n_tiles", "it < 2 * n_tiles").replace(
        "(lo + it)", "(lo + it % n_tiles)"), 1)
    for old, new in [
            ("for (int it = 1; it < n_tiles; ++it) {",
             "for (int it = 1; it < 2 * n_tiles; ++it) {"),
            ("if (WG == 0 || it + 1 < n_tiles) bar_arrive",
             "if (WG == 0 || it + 1 < 2 * n_tiles) bar_arrive"),
            ("if (WG == 0 || n_tiles > 1) bar_arrive",
             "if (WG == 0 || 2 * n_tiles > 1) bar_arrive"),
            ("softmax(s, m, l, corr, (lo + it) * kBK);",
             "softmax(s, m, l, corr, (lo + it % n_tiles) * kBK);"),
            ("const int pst = (n_tiles - 1) % C::kStages;",
             "const int pst = (2 * n_tiles - 1) % C::kStages;"),
            ("((n_tiles - 1) / C::kStages) & 1",
             "((2 * n_tiles - 1) / C::kStages) & 1"),
            (REFILL, REFILL.replace("n_tiles", "2 * n_tiles")),
            # hd 256: thread 0's first stages, in the doubled producer loop
            ("lo, min(n_tiles, C::kStages))",
             "lo, min(n_tiles, C::kStages / 2))"),
            ("(lo + it + C::kStages) * kBK",
             "(lo + (it + C::kStages) % n_tiles) * kBK")]:
        double = edit(double, lit(old), new, 1)
    return {"kernel": SRC, "no_softmax": no_softmax + tail,
            "gemm_only": gemm_only + tail, "no_pingpong": no_pingpong + tail,
            "no_exp2": no_exp2 + tail, "double": double + tail}


def compile_all(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
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
        notes = [ln.strip() for ln in log.splitlines()
                 if "C75" in ln or "spill stores" in ln]
        print(f"built {name}: " + "; ".join(notes), flush=True)
        libs[name] = fa.bind(ctypes.CDLL(str(OUT / f"{name}.so")))[0]
    return libs


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    sources = variants()
    libs = compile_all({n: sources[n] for n in names or sources})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for b, s, h, hd in SHAPES:
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (torch.randn(b, s, h, hd, generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        want = fa.flash_attention_plain(q, k, v)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in libs.items():
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, 1, b, h, s, s, hd,
                         *q.stride()[:3],
                         *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                         1, 0, 0, hd ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(3):
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 20)
            err = (out.float() - want.float()).abs().max().item()
            print(f"{(b, s, h, hd)} {name:12s} ms "
                  + " ".join(f"{t:.4f}" for t in times)
                  + (f" max_abs_err {err:.4g}" if name == "kernel" else "")
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
