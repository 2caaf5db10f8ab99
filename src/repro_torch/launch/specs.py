"""The (arch x shape) cells, ported from `repro.launch.specs`: each cell's
step function and its arguments, which the dry run (`launch.dryrun`)
traces on fake tensors and a real run runs.

`build_cell` builds the arguments under the active fake mode
(`torch._subclasses.FakeTensorMode`: shapes and dtypes, no data; the
counterpart of `jax.eval_shape`), or, with no fake mode active, as real
tensors drawn from `seed`.  The modality frontends are stubs as in the
JAX package: the Whisper cell gets precomputed (B, frames, d_model)
embeddings; Chameleon's VQ image tokens are ordinary vocab ids.  Tokens
are int64, the port's token dtype (the JAX specs' are int32).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import lm as lm_mod
from repro_torch.optim import AdamWConfig, adamw_init, make_train_step
from repro_torch.optim.schedules import cosine, wsd

TOKENS = torch.long


def schedule_for(cfg: ArchConfig):
    """MiniCPM trains with WSD (its paper's contribution); others cosine."""
    if "minicpm" in cfg.name:
        return partial(wsd, peak=1e-2, warmup=2000, total=100_000)
    return partial(cosine, peak=3e-4, warmup=2000, total=100_000)


def _tokens(shape, vocab: int, device, generator) -> torch.Tensor:
    if generator is None:   # a fake mode: no values
        return torch.zeros(shape, dtype=TOKENS, device=device)
    return torch.randint(0, vocab, shape, generator=generator,
                         device=device, dtype=TOKENS)


def _frames(cfg: ArchConfig, batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, cfg.encdec.n_frames, cfg.d_model),
                       dtype=torch.bfloat16, device=device)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, device="cuda",
                      generator: torch.Generator | None = None) -> dict:
    """tokens and labels (B, S) (drawn from `generator` where one is
    given, else zeros), plus zero bf16 frames (B, n_frames, d_model) for
    an encoder-decoder."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _tokens((b, s), cfg.vocab, device, generator),
             "labels": _tokens((b, s), cfg.vocab, device, generator)}
    if cfg.encdec is not None:
        batch["frames"] = _frames(cfg, b, device)
    return batch


@dataclasses.dataclass
class Cell:
    """One (arch x shape) unit: the step function and its arguments (fake
    or real tensors); `donate` names the arguments the step updates in
    place (the train state, the cache)."""

    name: str
    step_fn: object
    args: tuple
    donate: tuple = ()


def build_cell(cfg: ArchConfig, shape: ShapeSpec, *, device="cuda",
               remat: str = "full", kv_cache_dtype=torch.bfloat16) -> Cell:
    """The cell of `cfg` at `shape` on `device`: under a fake mode fake
    tensors, else real ones (params from seed 0, tokens from seed 1):

    * train: fp32 master params, their AdamW state, and a batch; the step
      is `make_train_step(model.loss, ...)` (the state updated in place);
    * prefill: bf16 serving params, tokens (B, S) and the cache of S
      positions (plus frames); the step is `model.prefill`;
    * decode: the params, one token (B, 1), the cache of S positions and
      the index S - 1, where the new token's keys go (plus the encoder's
      output); the step is `model.decode_step`.

    Serving steps run under `torch.no_grad`."""
    fake = detect_fake_mode() is not None
    dev = torch.device(device)
    if not fake and dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    model = lm_mod.build(cfg, remat=remat, kv_cache_dtype=kv_cache_dtype)
    gen = None if fake else torch.Generator(dev).manual_seed(0)
    tok_gen = None if fake else torch.Generator(dev).manual_seed(1)
    name = f"{cfg.name}/{shape.name}"
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        step = make_train_step(model.loss,
                               AdamWConfig(schedule=schedule_for(cfg)))
        state = adamw_init(model.init(gen, torch.float32, device=dev))
        batch = train_batch_specs(cfg, shape, dev, tok_gen)
        return Cell(name, step, (state, batch), donate=(0,))

    params = model.init(gen, torch.bfloat16, device=dev)
    cache = model.init_cache(b, s, dev)
    encdec = cfg.encdec is not None

    if shape.kind == "prefill":
        tokens = _tokens((b, s), cfg.vocab, dev, tok_gen)

        @torch.no_grad()
        def prefill_fn(p, t, c, f=None):
            return model.prefill(p, t, c, **({"frames": f} if encdec else {}))
        args = (params, tokens, cache) + ((_frames(cfg, b, dev),)
                                          if encdec else ())
        return Cell(name, prefill_fn, args, donate=(2,))

    # decode: one new token against a cache of length seq_len
    tokens = _tokens((b, 1), cfg.vocab, dev, tok_gen)

    @torch.no_grad()
    def decode_fn(p, t, c, i, e=None):
        return model.decode_step(p, t, c, i,
                                 **({"enc_out": e} if encdec else {}))
    args = (params, tokens, cache, s - 1) + ((_frames(cfg, b, dev),)
                                             if encdec else ())
    return Cell(name, decode_fn, args, donate=(2,))


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device="cuda") -> dict:
    """The model inputs of the cell, as fake tensors (under the active
    fake mode, else a new one): a train batch, the prefill's tokens, or
    the decode's token and index (a 0-d int64)."""
    if detect_fake_mode() is None:
        with FakeTensorMode():
            return input_specs(cfg, shape, device)
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, device)
    b = shape.global_batch
    if shape.kind == "prefill":
        return {"tokens": torch.zeros((b, shape.seq_len), dtype=TOKENS,
                                      device=device)}
    return {"tokens": torch.zeros((b, 1), dtype=TOKENS, device=device),
            "index": torch.zeros((), dtype=TOKENS, device=device)}
