"""Batched serving: prefill + greedy decode loop with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 2048 --gen 16

`--arch` takes every architecture `models.lm.build` accepts: the dense
family (tinyllama-1.1b, qwen3-14b, gemma-7b, minicpm-2b, and
chameleon-34b's backbone), deepseek-moe-16b, deepseek-v3-671b (MLA over
its latent cache; at full depth it does not fit one card), hymba-1.5b,
rwkv6-3b and whisper-small (the encoder-decoder, given zero bf16 frames
(B, n_frames, d_model) as the JAX `launch.serve.main` gives them).  Runs on `cuda`
unless `--device cpu` is given; without a GPU and without that flag it
raises.  Weights and prompts are random, from fixed seeds.
"""

from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch import obs
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
             gen: int, frames: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy generation: (B, prompt_len) prompts -> (B, gen) tokens.  An
    encoder-decoder model encodes `frames` once and hands the encoder's
    output to the prefill and to every decode step (the JAX `generate`
    hands its decode steps neither, and raises at the first: R14)."""
    b, prompt_len = prompts.shape
    with obs.span("generate", prompts, batch=b, length=prompt_len, gen=gen):
        cache = model.init_cache(b, max_seq, prompts.device)
        kw = ({} if model.cfg.encdec is None
              else {"enc_out": model.encode(params, frames)})
        with obs.span("generate.prefill", prompts):
            logits = model.prefill(params, prompts, cache, **kw)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out = [tok]
        for i in range(gen - 1):
            logits = model.decode_step(params, tok, cache, prompt_len + i,
                                       **kw)
            tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
            out.append(tok)
        toks = torch.cat(out, dim=1)
        obs.mark("generate.enqueued", prompts)
    return toks


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
    frames = None
    if cfg.encdec is not None:
        frames = torch.zeros((args.batch, cfg.encdec.n_frames, cfg.d_model),
                             dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.prompt_len + args.gen,
                    args.gen, frames)
    first = toks[0].tolist()   # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    print(first)
    return toks


if __name__ == "__main__":
    main()
