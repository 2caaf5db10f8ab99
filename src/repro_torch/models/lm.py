"""LM assembly, ported from `repro.models.lm` (the dense family and
RWKV6).

The JAX package stacks each segment's layer params on a leading axis and
`lax.scan`s over them; here a segment is a list of per-layer param dicts
walked by a Python loop.  The JAX sharding constraints have no
counterpart: with no mesh they are the identity.  `build` raises
NotImplementedError for every other family.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.layers import AttnDims, Params

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def layer_plan(cfg: ArchConfig) -> tuple[Segment, ...]:
    """One segment of `n_layers` identical blocks (dense or rwkv)."""
    return (Segment("rwkv" if cfg.rwkv else "dense", cfg.n_layers),)


def attn_dims(cfg: ArchConfig) -> AttnDims:
    return AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)


def rwkv_dims(cfg: ArchConfig) -> blocks.RWKVDims:
    return blocks.RWKVDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                           d_ff=cfg.d_ff)


# ---------------------------------------------------------------------------
# Per-block init / apply / cache
# ---------------------------------------------------------------------------


def _init_block(generator: torch.Generator, cfg: ArchConfig,
                seg: Segment) -> Params:
    d, dev = cfg.d_model, generator.device
    if seg.kind == "rwkv":
        return {"ln_tmix": layers.init_rmsnorm(d, dev),
                "ln_cmix": layers.init_rmsnorm(d, dev),
                "tmix": blocks.init_rwkv_tmix(generator, rwkv_dims(cfg)),
                "cmix": blocks.init_rwkv_cmix(generator, rwkv_dims(cfg))}
    return {"ln_attn": layers.init_rmsnorm(d, dev),
            "ln_mlp": layers.init_rmsnorm(d, dev),
            "attn": layers.init_attention(generator, attn_dims(cfg)),
            "ffn": layers.init_mlp(generator, d, cfg.d_ff)}


def _apply_block(lp: Params, cfg: ArchConfig, seg: Segment,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 cache: Params | None = None, cache_index: int | None = None,
                 force: str | None = None) -> torch.Tensor:
    """One block; writes `cache` in place (the KV slots, or the rwkv
    block's state entries replaced by the new bf16 state)."""
    if seg.kind == "rwkv":
        dims = rwkv_dims(cfg)
        t_out, t_state = blocks.rwkv_tmix(
            lp["tmix"], dims, layers.rmsnorm(lp["ln_tmix"], x),
            state=None if cache is None else cache["tmix"], force=force)
        x = x + t_out
        c_out, c_state = blocks.rwkv_cmix(
            lp["cmix"], dims, layers.rmsnorm(lp["ln_cmix"], x),
            state=None if cache is None else cache["cmix"])
        if cache is not None:
            cache["tmix"], cache["cmix"] = t_state, c_state
        return x + c_out
    rs = layers.scalar_as(cfg.residual_scale, x.dtype)
    h = layers.rmsnorm(lp["ln_attn"], x)
    attn_out = layers.attention(
        lp["attn"], attn_dims(cfg), h, positions,
        kv_cache=None if cache is None else cache["kv"],
        cache_index=cache_index, force=force)
    x = x + attn_out * rs
    h2 = layers.rmsnorm(lp["ln_mlp"], x)
    return x + layers.mlp(lp["ffn"], h2, cfg.activation) * rs


def _init_block_cache(cfg: ArchConfig, seg: Segment, batch: int,
                      max_seq: int, device) -> Params:
    if seg.kind == "rwkv":   # fixed-size state: max_seq plays no part
        return blocks.init_rwkv_state(batch, rwkv_dims(cfg), device)
    return {"kv": layers.init_kv_cache(batch, max_seq, attn_dims(cfg),
                                       device)}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class LM:
    """Decoder LM, dense or RWKV6 family.  `force` is handed to the kernel
    dispatcher: `ops.attention` on every prefill, `ops.rwkv_mix` on every
    call (None: dispatch by length and device)."""

    def __init__(self, cfg: ArchConfig, force: str | None = None):
        self.cfg = cfg
        self.force = force
        self.plan = layer_plan(cfg)

    def init(self, generator: torch.Generator) -> Params:
        """Random params on the generator's device, with the scales of the
        JAX package's `truncated_normal` init (different draws)."""
        cfg = self.cfg
        params: Params = {
            "embed": layers.init_embed(generator, cfg.vocab, cfg.d_model,
                                       tied=cfg.tied_embeddings),
            "ln_f": layers.init_rmsnorm(cfg.d_model, generator.device),
        }
        for i, seg in enumerate(self.plan):
            params[f"seg{i}"] = [_init_block(generator, cfg, seg)
                                 for _ in range(seg.count)]
        return params

    def _hidden(self, params: Params, tokens: torch.Tensor, cache=None,
                cache_index: int | None = None) -> torch.Tensor:
        """Final-norm hidden states (B,S,d); writes `cache` in place."""
        cfg = self.cfg
        base = 0 if cache_index is None else cache_index
        positions = base + torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        scale = cfg.d_model ** 0.5 if cfg.embed_scale_by_dim else 1.0
        x = layers.embed(params["embed"], tokens, scale)
        for i, seg in enumerate(self.plan):
            for j, lp in enumerate(params[f"seg{i}"]):
                x = _apply_block(
                    lp, cfg, seg, x, positions,
                    cache=None if cache is None else cache[f"seg{i}"][j],
                    cache_index=cache_index, force=self.force)
        return layers.rmsnorm(params["ln_f"], x)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(params["embed"], x,
                              cap=self.cfg.logit_cap or None)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """fp32 logits (B,S,V) of a full causal pass, no cache."""
        return self._logits(params, self._hidden(params, tokens))

    def init_cache(self, batch: int, max_seq: int, device) -> Params:
        return {f"seg{i}": [_init_block_cache(self.cfg, seg, batch, max_seq,
                                              device)
                            for _ in range(seg.count)]
                for i, seg in enumerate(self.plan)}

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: Params) -> torch.Tensor:
        """Fills cache positions [0, S) (or the rwkv state) in place;
        returns the last position's logits (B,1,V) (only that position is
        unembedded)."""
        x = self._hidden(params, tokens, cache=cache, cache_index=0)
        return self._logits(params, x[:, -1:])

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index: int) -> torch.Tensor:
        """tokens: (B, 1) at absolute position `index`; writes the cache
        in place and returns logits (B,1,V)."""
        return self._logits(params, self._hidden(params, tokens, cache=cache,
                                                 cache_index=index))


def build(cfg: ArchConfig, force: str | None = None) -> LM:
    if cfg.family != "dense" and not cfg.rwkv:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not ported (dense and rwkv only)")
    return LM(cfg, force=force)
