#!/usr/bin/env python3
"""What bounds the bf16 MLA-layout flash backward's wgmma kernels, on one
GPU.

    python3 tools/mla_bwd_ablation.py [--batch B] [VARIANT ...]

Builds variants of `src/repro_torch/kernels/csrc/flash_attention_bwd.cu`,
each with one part of the dK kernel (`flash_bwd_mla_dk_bf16`) or the dQ
kernel (`flash_bwd_mla_dq_bf16`) taken out by a text edit of the source
(the other kernels are kept as they are), prints ptxas's registers and
spills for both, and times each at DeepSeek-V3's training shape (B = 1
by default, 2048, 128 heads, 576 / 512, v a view of k), bf16, causal,
called as the main
path calls it (dV into dK): each launch's device time by profiler over 3
calls, after a warm-up.  Only `kernel` computes the right answer; its
error against the plain twin (max abs over max(max |want|, 1)) is
printed.  The variants:

  kernel       the source as it is
  no_exchange  no hand-over between the warpgroups in either kernel: no
               named barriers, P and dS not written to shared memory; each
               warpgroup takes its own product's tile as P or as dS
  no_pdo       the dK kernel without its P^T dO half (dV not summed in)
  no_rs        neither kernel's register-operand products (dS^T Q, P^T dO,
               dS K): the S and dP products, the softmax and the exchange
               alone
  ascending    the dK kernel walks its steps from the lowest position up,
               not from the top down (the blocks of a head group then read
               the same Q and dO rows at different times)
  no_refill    neither kernel loads a stage past the first ones (the
               products on stale tiles): no L2 traffic in the loops
  one_stage    both kernels with one stage of their streamed operand
               where v is a view of k (as with a separate v): each refill
               waits for the whole step's products, as one 64-key K stage
               in dQ would
  batch_inner  the dK kernel's blocks in (key tile, group, batch) order,
               the batch fastest, not (batch, key tile, group): at B > 1
               the resident blocks then spread over the sequences

The no_exchange build of the dK kernel (kFused) has its wgmma serialized
by ptxas (C7511: the registers it frees go elsewhere), so its dK time
says nothing of the exchange; its dQ time does.

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

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SRC = (build.CSRC / "flash_attention_bwd.cu").read_text()
OUT = build.BUILD_DIR / "mla_bwd_ablation"
# the MLA wgmma kernels' region of the source: the edits reach only it
BEGIN, END = "namespace mla_tc {", "int launch_mla_dk("
SHAPE = (1, 2048, 128)         # (B, S, H)
SCALE = 192 ** -0.5            # V3's qk_dim ** -0.5
PARTS = ("flash_bwd_delta", "flash_bwd_mla_dk_bf16", "flash_bwd_mla_sum",
         "flash_bwd_mla_dq_bf16")


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
    no_exchange = edit(mla, r"\n *bar_(arrive|sync)\([12]\);[^\n]*", "", 8)
    no_exchange = edit(no_exchange, r"\n *for \(int i = 0; i < 16; \+\+i\) "
                                    r"xch\[128 \* i\] = x\[i\];", "", 2)
    no_exchange = edit(no_exchange, r"ych\[128 \* \(4 \* kk \+ r\)\] = "
                                    r"dsa\[kk\]\[r\];", "(void)0;", 2)
    no_exchange = edit(no_exchange, r"dsa\[kk\]\[r\] = ych\[128 \* "
                                    r"\(4 \* kk \+ r\)\];",
                       "dsa[kk][r] = __float_as_uint(x[4 * kk + r]);", 2)
    no_exchange = edit(no_exchange, lit("pt[i] = xch[128 * i];"),
                       "pt[i] = y[i];", 1)
    no_exchange = edit(no_exchange, lit("y[i] = xch[128 * i] * "),
                       "y[i] = y[i] * ", 1)
    no_pdo = edit(mla, lit("if constexpr (kPdO) issue_rs_mla(acc, pa, "
                           "do_st + own);"), "", 1)
    no_rs = edit(mla, r"\n *(if constexpr \(k\w+\) )?issue_rs_mla\([^;]*;",
                 "", 5)
    ascending = edit(mla, lit("top - (it + 1) * npos"),
                     "top - (n_steps - it) * npos", 2)
    ascending = edit(ascending, lit("pos0 - C::kStages * npos"),
                     "pos0 + C::kStages * npos", 2)
    no_refill = edit(mla, lit("if (release_last<kWarps>(base + C::kCount + "
                              "8 * st) && refill)"),
                     "if (release_last<kWarps>(base + C::kCount + 8 * st) "
                     "&& false)", 1)
    no_refill = edit(no_refill, lit("it + C::kStages < n_tiles && lane == 0)"),
                     "false)", 1)
    no_refill = edit(no_refill, r"\n *mbar_wait\(base \+ C::k(QFull|LFull|"
                                r"KFull) \+ 8 \* st, [^;]*;", "", 3)
    batch_inner = edit(mla, lit(
        "  const int n_kt = gridDim.x / (n_hg * B);\n"
        "  const int b = blockIdx.x / (n_kt * n_hg);\n"
        "  const int kt = blockIdx.x / n_hg % n_kt, hg = blockIdx.x % n_hg;"
        "\n"),
        "  const int kt = blockIdx.x / (n_hg * B);\n"
        "  const int hg = (blockIdx.x / B) % n_hg, b = blockIdx.x % B;\n", 1)
    one_stage = edit(mla, lit("static constexpr int kStages = kShared ? 2 "
                              ": 1;"), "static constexpr int kStages = 1;", 2)
    return {name: head + body + tail for name, body in [
        ("kernel", mla), ("no_exchange", no_exchange), ("no_pdo", no_pdo),
        ("no_rs", no_rs), ("ascending", ascending),
        ("no_refill", no_refill), ("one_stage", one_stage),
        ("batch_inner", batch_inner)]}


def compile_all(sources: dict[str, str]) -> dict[str, object]:
    """One nvcc per variant, all started together; prints each build's
    registers and spills for the MLA wgmma kernels and its C75xx lines."""
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
            m = re.search(r"(flash_bwd_mla_d[kq]_bf16)I(\w+?)EEv", ln)
            if "Compiling entry function" in ln and m:
                notes += [f"{m.group(1)}<{m.group(2)}>: " + "; ".join(
                    x.strip() for x in lines[i + 1:i + 5]
                    if "spill" in x or "registers" in x)]
        print(f"built {name}: " + " | ".join(notes), flush=True)
        libs[name] = fa.bind_bwd_mla(ctypes.CDLL(str(OUT / f"{name}.so")))
    return libs


def main(args: list[str]) -> int:
    batch = 1
    if args[:1] == ["--batch"]:
        batch, args = int(args[1]), args[2:]
    names = args
    if not torch.cuda.is_available():
        print("mla_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sources = variants()
    libs = compile_all({n: sources[n] for n in names or sources})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    b, s, h = (batch, *SHAPE[1:])
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(b, s, h, 576, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, s, 1, 576, generator=g, device="cuda").bfloat16()
    v = k[..., :512]
    do = torch.randn(b, s, h, 512, generator=g, device="cuda").bfloat16()
    kw = dict(causal=True, scale=SCALE)
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    want = ref.flash_attention_bwd_plain(q, k, v, out, do, lse, 512,
                                         dv_into_dk=True, **kw)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    delta = torch.empty(b, h, s, device="cuda")
    strides = (ctypes.c_longlong * 24)(*(
        x for t in (q, k, v, out, do, dq, dk, dk) for x in t.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream
    for name, (fn, scratch) in libs.items():
        part = torch.empty(scratch(b, h, s, 1, 1), device="cuda")

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     part.data_ptr(), dq.data_ptr(), dk.data_ptr(), None, 1,
                     1, 1, b, h, s, s, strides, 1, 0, 0, SCALE, stream)
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        times = []
        for part_name in PARTS:
            hit = [e for e in rows if part_name in e.key]
            n = sum(e.count for e in hit)
            ms = sum(e.self_device_time_total for e in hit) / 1e3 / max(n, 1)
            times.append(f"{part_name.replace('flash_bwd_', '')} "
                         + (f"{ms:.4f}" if n else "not measured"))
        err = max(((a.float() - w.float()).abs().max()
                   / w.float().abs().max().clamp_min(1.0)).item()
                  for a, w in zip((dq, dk), want[:2]))
        print(f"{(b, s, h)} {name:11s} ms " + ", ".join(times)
              + (f"; max abs err over max(max |want|, 1) {err:.4g}"
                 if name == "kernel" else "")
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
