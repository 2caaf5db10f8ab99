"""Batched serving: prefill + greedy decode loop with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 2048 --gen 16

`--arch` takes every architecture `models.lm.build` accepts: the dense
family (tinyllama-1.1b, qwen3-14b, gemma-7b, minicpm-2b, and
chameleon-34b's backbone), deepseek-moe-16b, deepseek-v3-671b (MLA over
its latent cache; at full depth it does not fit one card), hymba-1.5b and
rwkv6-3b.  Runs on `cuda` unless `--device cpu` is given; without a GPU
and without that flag it raises.  Weights and prompts are random, from
fixed seeds.
"""

from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch.models import lm as lm_mod


def resolve_device(device: str) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass --device cpu to run on the CPU")
    return dev


@torch.inference_mode()
def generate(model, params, prompts: torch.Tensor, max_seq: int,
             gen: int) -> torch.Tensor:
    """Greedy generation: (B, prompt_len) prompts -> (B, gen) tokens."""
    b, prompt_len = prompts.shape
    cache = model.init_cache(b, max_seq, prompts.device)
    logits = model.prefill(params, prompts, cache)
    tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(gen - 1):
        logits = model.decode_step(params, tok, cache, prompt_len + i)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=args.reduced)
    model = lm_mod.build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.prompt_len + args.gen,
                    args.gen)
    first = toks[0].tolist()   # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    print(first)
    return toks


if __name__ == "__main__":
    main()
