"""Training driver, ported from `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --device cpu --steps 30

Wires config -> model (fp32 master params) -> data pipeline -> AdamW
(+ schedule) -> checkpoint manager -> resilient loop (straggler detection,
checkpoint / restart, optional fault injection).  One device, no mesh: it
runs on `cuda` unless `--device cpu` is given, and without a GPU and
without that flag it raises.  On the GPU every attention call at
Sq >= 2048 runs the flash forward and backward kernels, every RWKV6
time-mix the wkv6 forward and backward kernels, and every SSM of the
hybrid (Hymba) the selective-scan forward and backward kernels; at
DeepSeek-V3's latent (MLA) layout the attention runs the MLA-layout flash
forward and backward kernels.  Every family `models.lm.build` builds
trains there, as on the CPU: dense, MoE (DeepSeek-MoE, and DeepSeek-V3
with its MTP loss), the hybrid, RWKV6 and, through `build_trainer` with
batches that carry frames, the encoder-decoder (Whisper).  `main` refuses
an encoder-decoder arch: its data pipeline carries no frames (the JAX
`launch.train.main` fails there with a KeyError after its retries: R15).
"""

from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import fault
from repro_torch.distributed.compression import EFCompressor
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.specs import schedule_for
from repro_torch.models import lm as lm_mod
from repro_torch.optim import AdamWConfig, adamw_init, make_train_step


def build_trainer(cfg, *, device, compression: str = "none",
                  remat: str = "full"):
    """(model, state, step, compressor): fp32 master params from seed 0 on
    `device`, their AdamW state, the train step (`schedule_for(cfg)`'s LR)
    and the gradient compressor.  As in the JAX driver, the compressor is
    built and not applied: on one device no gradient crosses a link.

    An encoder-decoder config (Whisper) trains on batches that carry
    "frames" beside "tokens" and "labels", laid out as the JAX package's
    `launch.specs.train_batch_specs` lays them out: (B, n_frames, d_model)
    in bf16."""
    dev = torch.device(device)
    model = lm_mod.build(cfg, remat=remat)
    step = make_train_step(model.loss, AdamWConfig(schedule=schedule_for(cfg)))
    params = model.init(torch.Generator(dev).manual_seed(0),
                        dtype=torch.float32)
    return model, adamw_init(params), step, EFCompressor(kind=compression)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", default="full", choices=lm_mod.REMATS)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, reduced=args.reduced)
    if cfg.encdec is not None:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder trains on batches that carry "
            "frames (B, n_frames, d_model) beside its tokens, and the data "
            "pipeline (SyntheticTokens) carries none; call build_trainer's "
            "step with such batches")
    dev = resolve_device(args.device)
    _, state, step, _ = build_trainer(cfg, device=dev,
                                      compression=args.compression,
                                      remat=args.remat)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))
    manager = CheckpointManager(args.ckpt_dir, keep=2)
    start, restored = manager.restore_latest(state)
    if restored is not None:
        state = restored
        print(f"resumed from step {start}")

    def step_fn(st, batch_):   # token ids only: an encdec arch never gets here
        return step(st, {k: torch.from_numpy(v).to(dev, torch.long)
                         for k, v in batch_.items()})

    t0 = time.time()
    state, log = fault.run_resilient(
        state, data, step_fn, manager, n_steps=args.steps,
        checkpoint_every=args.checkpoint_every, fault_at=args.fault_at)
    losses = [m["loss"] for m in log]
    for i, m in enumerate(log):
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}")
    dt = time.time() - t0
    print(f"done: {len(log)} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
