"""LM assembly, ported from `repro.models.lm`: the dense family (Chameleon's
`vlm` backbone among it), DeepSeek-MoE (a leading dense segment, then MoE
blocks with GQA attention), DeepSeek-V3 (the same segments with MLA
attention over a latent cache), Hymba (hybrid blocks: attention and the
selective SSM side by side, global attention in a few layers and a
sliding window, with a ring-buffer KV cache, in the others), RWKV6, and
the encoder-decoder (Whisper: `WhisperLM`, a non-causal encoder over
precomputed frame embeddings and "crossdec" decoder blocks that add
cross-attention to the encoder's output).

The JAX package stacks each segment's layer params (and Whisper's encoder
blocks) on a leading axis and `lax.scan`s over them; here a segment is a
list of per-layer param dicts walked by a Python loop.  The JAX sharding
constraints have no counterpart: with no mesh they are the identity.

Training: `LM.loss` is the next-token cross-entropy, plus 0.01 x the MoE
blocks' load-balance loss summed over the layers for a MoE config, plus
0.3 x the multi-token-prediction (MTP) loss for an MTP config
(DeepSeek-V3: `LM._mtp_loss`), and `remat` recomputes each trunk block in
the backward as the JAX `jax.checkpoint` does (the MTP block is not
recomputed, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint as ckpt
from torch._guards import detect_fake_mode

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.models import blocks, layers
from repro_torch.models.layers import AttnDims, Params

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: int | None = None   # sliding window for hybrid SWA segments


def layer_plan(cfg: ArchConfig) -> tuple[Segment, ...]:
    """Segments of identical blocks: one of `n_layers` (dense, rwkv, or
    for an encoder-decoder the "crossdec" decoder blocks); for a hybrid
    (SSM) config one "hybrid" segment per global-attention layer and one
    per run of sliding-window layers between them; for a MoE config its
    `first_dense_layers` ("dense_lead", an MLP of `dense_d_ff`) and then
    the MoE blocks."""
    if cfg.encdec is not None:
        return (Segment("crossdec", cfg.n_layers),)
    if cfg.rwkv:
        return (Segment("rwkv", cfg.n_layers),)
    if cfg.ssm is not None:
        glb = set(cfg.ssm.global_attn_layers)
        segs, i = [], 0
        while i < cfg.n_layers:
            j = i + 1
            if i not in glb:
                while j < cfg.n_layers and j not in glb:
                    j += 1
            segs.append(Segment("hybrid", j - i, None if i in glb
                                else cfg.ssm.sliding_window))
            i = j
        return tuple(segs)
    if cfg.moe is not None:
        lead = cfg.moe.first_dense_layers
        return ((Segment("dense_lead", lead),) if lead else ()) + (
            Segment("moe", cfg.n_layers - lead),)
    return (Segment("dense", cfg.n_layers),)


def attn_dims(cfg: ArchConfig, window: int | None = None) -> AttnDims:
    return AttnDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                    window=window)


def moe_dims(cfg: ArchConfig) -> blocks.MoEDims:
    m = cfg.moe
    return blocks.MoEDims(d_model=cfg.d_model, n_experts=m.n_experts,
                          top_k=m.top_k, d_expert=m.d_expert,
                          n_shared=m.n_shared, group_size=m.group_size,
                          capacity_factor=m.capacity_factor)


def mla_dims(cfg: ArchConfig) -> blocks.MLADims:
    m = cfg.mla
    return blocks.MLADims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                          q_lora_rank=m.q_lora_rank,
                          kv_lora_rank=m.kv_lora_rank,
                          qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                          v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta)


def uses_mla(cfg: ArchConfig, seg: Segment) -> bool:
    """Every dense-lead and MoE block of an MLA config attends by MLA."""
    return cfg.mla is not None and seg.kind in ("moe", "dense_lead")


def ssm_dims(cfg: ArchConfig) -> blocks.SSMDims:
    return blocks.SSMDims(d_model=cfg.d_model, d_inner=cfg.d_model,
                          state_dim=cfg.ssm.state_dim, conv_k=cfg.ssm.conv_k)


def rwkv_dims(cfg: ArchConfig) -> blocks.RWKVDims:
    return blocks.RWKVDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                           d_ff=cfg.d_ff)


# ---------------------------------------------------------------------------
# Per-block init / apply / cache
# ---------------------------------------------------------------------------


def _init_block(generator: torch.Generator, cfg: ArchConfig,
                seg: Segment, dtype) -> Params:
    d, dev = cfg.d_model, generator.device
    if seg.kind == "rwkv":
        return {"ln_tmix": layers.init_rmsnorm(d, dev),
                "ln_cmix": layers.init_rmsnorm(d, dev),
                "tmix": blocks.init_rwkv_tmix(generator, rwkv_dims(cfg),
                                              dtype),
                "cmix": blocks.init_rwkv_cmix(generator, rwkv_dims(cfg),
                                              dtype)}
    p = {"ln_attn": layers.init_rmsnorm(d, dev),
         "ln_mlp": layers.init_rmsnorm(d, dev),
         "attn": (blocks.init_mla(generator, mla_dims(cfg), dtype)
                  if uses_mla(cfg, seg) else layers.init_attention(
                      generator, attn_dims(cfg, seg.window), dtype))}
    if seg.kind == "moe":
        p["ffn"] = blocks.init_moe(generator, moe_dims(cfg), dtype)
    else:
        d_ff = cfg.moe.dense_d_ff if seg.kind == "dense_lead" else cfg.d_ff
        p["ffn"] = layers.init_mlp(generator, d, d_ff, dtype)
    if seg.kind == "crossdec":
        p["ln_cross"] = layers.init_rmsnorm(d, dev)
        p["cross"] = layers.init_attention(generator, attn_dims(cfg), dtype)
    if seg.kind == "hybrid":
        p["ssm"] = blocks.init_ssm(generator, ssm_dims(cfg), dtype)
        p["ln_attn_out"] = layers.init_rmsnorm(d, dev)
        p["ln_ssm_out"] = layers.init_rmsnorm(d, dev)
    return p


def _apply_block(lp: Params, cfg: ArchConfig, seg: Segment,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 causal: bool = True, cache: Params | None = None,
                 cache_index: int | None = None, force: str | None = None,
                 cross_ctx: torch.Tensor | None = None):
    """One block: (x, aux), aux the MoE block's fp32 load-balance loss or
    None.  Writes `cache` in place (the KV slots, and the rwkv or SSM
    state entries replaced by the new bf16 state).  A hybrid block adds
    0.5 x (rmsnorm(attention) + rmsnorm(SSM)) of the same normed input,
    then the MLP.  A crossdec block given `cross_ctx` (the encoder's
    output) adds its cross-attention between the self-attention and the
    MLP.  `causal` reaches the GQA self-attention (False: Whisper's
    encoder)."""
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
        return x + c_out, None
    rs = layers.scalar_as(cfg.residual_scale, x.dtype)
    h = layers.rmsnorm(lp["ln_attn"], x)
    kv = None if cache is None else cache["kv"]
    if uses_mla(cfg, seg):
        attn_out = blocks.mla_attention(
            lp["attn"], mla_dims(cfg), h, positions, kv_cache=kv,
            cache_index=cache_index, force=force)
    else:
        attn_out = layers.attention(
            lp["attn"], attn_dims(cfg, seg.window), h, positions,
            causal=causal, kv_cache=kv, cache_index=cache_index, force=force)
    if seg.kind == "hybrid":
        ssm_out, ssm_state = blocks.ssm(
            lp["ssm"], ssm_dims(cfg), h,
            state=None if cache is None else cache["ssm"], force=force)
        if cache is not None:
            cache["ssm"] = ssm_state
        attn_out = 0.5 * (layers.rmsnorm(lp["ln_attn_out"], attn_out)
                          + layers.rmsnorm(lp["ln_ssm_out"], ssm_out))
    x = x + attn_out * rs
    if seg.kind == "crossdec" and cross_ctx is not None:
        x = x + _cross_attention(lp["cross"], cfg,
                                 layers.rmsnorm(lp["ln_cross"], x),
                                 cross_ctx) * rs
    h2 = layers.rmsnorm(lp["ln_mlp"], x)
    aux = None
    if seg.kind == "moe":
        ffn_out, aux = blocks.moe(lp["ffn"], moe_dims(cfg), h2)
    else:
        ffn_out = layers.mlp(lp["ffn"], h2, cfg.activation)
    return x + ffn_out * rs, aux


def _cross_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     ctx: torch.Tensor) -> torch.Tensor:
    """Whisper's cross-attention: q from x, k and v from the encoder's
    output `ctx` (weights cast to x's dtype), no RoPE and no qk-norm, GQA
    expanded, every key visible.  Always the naive SDPA
    (`ref.naive_attention`: fp32 logits, probabilities in q's dtype),
    whatever the lengths, as the JAX package calls `attention_scores`
    here and not the kernel dispatcher."""
    dims = attn_dims(cfg)
    q = layers._matmul(x, p["wq"])
    k = layers._matmul(ctx, p["wk"].to(x.dtype))
    v = layers._matmul(ctx, p["wv"].to(x.dtype))
    out = ref.naive_attention(q, layers._expand_kv(k, dims.n_heads),
                              layers._expand_kv(v, dims.n_heads),
                              causal=False)
    return layers._matmul(out, p["wo"], n_in=2)


def _init_block_cache(cfg: ArchConfig, seg: Segment, batch: int,
                      max_seq: int, device, dtype=torch.bfloat16) -> Params:
    """`dtype` is the KV (or MLA latent) cache's; the rwkv and SSM states
    keep theirs, as in the JAX package."""
    if seg.kind == "rwkv":   # fixed-size state: max_seq plays no part
        return blocks.init_rwkv_state(batch, rwkv_dims(cfg), device)
    cache = {"kv": blocks.init_mla_cache(batch, max_seq, mla_dims(cfg), device,
                                         dtype)
             if uses_mla(cfg, seg) else layers.init_kv_cache(
                 batch, max_seq, attn_dims(cfg, seg.window), device, dtype)}
    if seg.kind == "hybrid":
        cache["ssm"] = blocks.init_ssm_state(batch, ssm_dims(cfg), device)
    return cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _init_source(generator, device):
    """What the init functions draw from: `generator`, or where `device`
    names another device, a `layers.DeviceOnly` of it, which only a fake
    mode's shape-only init takes."""
    if device is None or (generator is not None and torch.device(device) in (
            generator.device, torch.device(generator.device.type))):
        if generator is None:
            raise ValueError("init: give a generator or a device")
        return generator
    if detect_fake_mode() is None:
        raise ValueError(f"init on {device} without a generator there "
                         "draws nothing: only under a fake mode")
    return layers.DeviceOnly(device)


REMATS = ("full", "dots", "none")
# the matrix products whose outputs remat="dots" keeps (JAX's dots_saveable)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class LM:
    """Decoder LM: dense, MoE (GQA or MLA attention), hybrid or RWKV6
    (`WhisperLM` below adds the encoder).  `force` is handed to the kernel
    dispatcher: `ops.attention` on every prefill, `ops.rwkv_mix` and
    `ops.ssm_scan` on every call (None: dispatch by length and device).

    `remat` sets what a block keeps for its backward when autograd records
    it (training; serving never recomputes): "full" keeps only the block's
    input and recomputes the block (`torch.utils.checkpoint`), "dots"
    keeps the matrix products' outputs and recomputes the rest, "none"
    keeps everything.

    `kv_cache_dtype` is the dtype of the KV and MLA latent caches that
    `init_cache` makes: bf16, or fp8 (torch.float8_e4m3fn), which halves
    them; attention still runs in bf16 / fp32 on the upcast values."""

    def __init__(self, cfg: ArchConfig, force: str | None = None,
                 remat: str = "full", kv_cache_dtype=torch.bfloat16):
        if remat not in REMATS:
            raise ValueError(f"remat={remat!r} not in {REMATS}")
        self.cfg = cfg
        self.force = force
        self.remat = remat
        self.kv_cache_dtype = kv_cache_dtype
        self.plan = layer_plan(cfg)

    def init(self, generator: torch.Generator | None,
             dtype=torch.bfloat16, *, device=None) -> Params:
        """Random params on the generator's device, with the scales of the
        JAX package's `truncated_normal` init (different draws).  Matmul
        weights (and RWKV's token-shift mixes) in `dtype`: bf16 for
        serving, fp32 masters for training; norm scales are fp32.  An MTP
        config also gets the JAX package's MTP params ("mtp": the (2d, d)
        projection, a dense-lead block, a norm), which `loss` reads and
        serving never does.

        `device` (default: the generator's) places the params elsewhere
        only under a fake mode, where nothing is drawn (the shape-only
        init; `generator` may then be None)."""
        generator = _init_source(generator, device)
        cfg = self.cfg
        params: Params = {
            "embed": layers.init_embed(generator, cfg.vocab, cfg.d_model,
                                       tied=cfg.tied_embeddings, dtype=dtype),
            "ln_f": layers.init_rmsnorm(cfg.d_model, generator.device),
        }
        for i, seg in enumerate(self.plan):
            params[f"seg{i}"] = [_init_block(generator, cfg, seg, dtype)
                                 for _ in range(seg.count)]
        if cfg.mtp:
            d = cfg.d_model
            params["mtp"] = {
                "proj": layers.truncated_normal((2 * d, d), (2 * d) ** -0.5,
                                                generator, dtype),
                "block": _init_block(generator, cfg, Segment(
                    "dense_lead" if cfg.moe else "dense", 1), dtype),
                "ln": layers.init_rmsnorm(d, generator.device),
            }
        return params

    def _block(self, lp, seg, x, positions, cache, cache_index, *,
               causal: bool = True, cross_ctx=None):
        """One block, recomputed in the backward as `remat` says when
        autograd records it without a cache.  `cross_ctx` is an input of
        the checkpoint like x, so its gradient (the encoder's) flows from
        every block that reads it."""
        kw = dict(causal=causal, force=self.force, cross_ctx=cross_ctx)
        if cache is not None or self.remat == "none" or not (
                torch.is_grad_enabled()):
            return _apply_block(lp, self.cfg, seg, x, positions, cache=cache,
                                cache_index=cache_index, **kw)
        context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_dots)
                   if self.remat == "dots" else ckpt.noop_context_fn)
        return ckpt.checkpoint(_apply_block, lp, self.cfg, seg, x, positions,
                               use_reentrant=False, context_fn=context, **kw)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        scale = cfg.d_model ** 0.5 if cfg.embed_scale_by_dim else 1.0
        return layers.embed(params["embed"], tokens, scale)

    def _hidden(self, params: Params, tokens: torch.Tensor, cache=None,
                cache_index: int | None = None, cross_ctx=None):
        """(final-norm hidden states (B,S,d), the MoE blocks' load-balance
        loss summed over the layers (fp32; None without MoE blocks));
        writes `cache` in place.  `cross_ctx` goes to every block (the
        crossdec blocks read it)."""
        base = 0 if cache_index is None else cache_index
        positions = base + torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        x = self._embed(params, tokens)
        aux_total = None
        for i, seg in enumerate(self.plan):
            for j, lp in enumerate(params[f"seg{i}"]):
                x, aux = self._block(
                    lp, seg, x, positions,
                    None if cache is None else cache[f"seg{i}"][j],
                    cache_index, cross_ctx=cross_ctx)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
        return layers.rmsnorm(params["ln_f"], x), aux_total

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(params["embed"], x,
                              cap=self.cfg.logit_cap or None)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """fp32 logits (B,S,V) of a full causal pass, no cache."""
        return self._logits(params, self._hidden(params, tokens)[0])

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy (z-loss 1e-4) of batch["tokens"]
        against batch["labels"], both (B,S), plus 0.01 x the load-balance
        loss for a MoE config and 0.3 x `_mtp_loss` for an MTP config."""
        tokens, labels = batch["tokens"], batch["labels"]
        x, aux = self._hidden(params, tokens)
        loss = layers.cross_entropy(self._logits(params, x), labels)
        if aux is not None:
            loss = loss + 0.01 * aux
        if self.cfg.mtp:
            loss = loss + 0.3 * self._mtp_loss(params, tokens, labels)
        return loss

    def _mtp_loss(self, params: Params, tokens: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """DeepSeek-V3's MTP term, as the JAX package computes it
        (`repro.models.lm.LM._mtp_loss`): the embeddings of the tokens
        (not the trunk's hidden states) and of the labels, concatenated and
        projected by mtp.proj (2d -> d), one dense-lead block (MLA
        attention) without remat, rmsnorm(mtp.ln), the shared unembedding,
        and the cross-entropy against the labels shifted by one more (the
        last label repeated)."""
        cfg, mtp = self.cfg, params["mtp"]
        h = torch.cat([self._embed(params, tokens),
                       self._embed(params, labels)], dim=-1)
        h = layers._matmul(h, mtp["proj"])
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        seg = Segment("dense_lead" if cfg.moe else "dense", 1)
        h, _ = _apply_block(mtp["block"], cfg, seg, h, positions,
                            force=self.force)
        logits = self._logits(params, layers.rmsnorm(mtp["ln"], h))
        return layers.cross_entropy(
            logits, torch.cat([labels[:, 1:], labels[:, -1:]], dim=1))

    def init_cache(self, batch: int, max_seq: int, device) -> Params:
        return {f"seg{i}": [_init_block_cache(self.cfg, seg, batch, max_seq,
                                              device, self.kv_cache_dtype)
                            for _ in range(seg.count)]
                for i, seg in enumerate(self.plan)}

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: Params) -> torch.Tensor:
        """Fills cache positions [0, S) (or the rwkv state) in place;
        returns the last position's logits (B,1,V) (only that position is
        unembedded)."""
        x, _ = self._hidden(params, tokens, cache=cache, cache_index=0)
        return self._logits(params, x[:, -1:])

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index: int) -> torch.Tensor:
        """tokens: (B, 1) at absolute position `index`; writes the cache
        in place and returns logits (B,1,V)."""
        x, _ = self._hidden(params, tokens, cache=cache, cache_index=index)
        return self._logits(params, x)


class WhisperLM(LM):
    """Encoder-decoder (`repro.models.lm.WhisperLM`): an encoder of
    `encdec.n_encoder_layers` non-causal dense blocks over stub frame
    embeddings (B, n_frames, d_model), RoPE over the frame positions, then
    rmsnorm(ln_enc); a decoder of crossdec blocks that attend to the
    encoder's output.  Embeddings unscaled, the unembedding uncapped, no
    aux loss and no MTP.  Every decoder entry point takes `frames` (the
    encoder runs on them) or `enc_out` (its output, as `encode` gives it;
    serving encodes once), and raises ValueError given neither.  `remat`
    recomputes encoder blocks as it does decoder blocks."""

    def __init__(self, cfg: ArchConfig, force: str | None = None,
                 remat: str = "full", kv_cache_dtype=torch.bfloat16):
        super().__init__(cfg, force=force, remat=remat,
                         kv_cache_dtype=kv_cache_dtype)
        self.enc_seg = Segment("dense", cfg.encdec.n_encoder_layers)

    def init(self, generator: torch.Generator | None,
             dtype=torch.bfloat16, *, device=None) -> Params:
        """`LM.init`'s params plus "encoder" (a list of dense blocks) and
        "ln_enc"."""
        generator = _init_source(generator, device)
        params = super().init(generator, dtype)
        params["encoder"] = [_init_block(generator, self.cfg, self.enc_seg,
                                         dtype)
                             for _ in range(self.enc_seg.count)]
        params["ln_enc"] = layers.init_rmsnorm(self.cfg.d_model,
                                               generator.device)
        return params

    def encode(self, params: Params,
               frames: torch.Tensor | None) -> torch.Tensor:
        """The encoder's output (B, n_frames, d_model) in frames' dtype."""
        if frames is None:
            raise ValueError(
                f"{self.cfg.name}: the encoder-decoder needs `frames` (B, "
                "n_frames, d_model) or `enc_out` (the encoder's output); "
                "got neither")
        positions = torch.arange(frames.shape[1], device=frames.device)[None]
        x = frames
        for lp in params["encoder"]:
            x, _ = self._block(lp, self.enc_seg, x, positions, None, None,
                               causal=False)
        return layers.rmsnorm(params["ln_enc"], x)

    def _context(self, params: Params, frames, enc_out) -> torch.Tensor:
        return self.encode(params, frames) if enc_out is None else enc_out

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(params["embed"], tokens)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(params["embed"], x)

    def forward(self, params: Params, tokens: torch.Tensor,
                frames: torch.Tensor | None = None,
                enc_out: torch.Tensor | None = None) -> torch.Tensor:
        ctx = self._context(params, frames, enc_out)
        return self._logits(params,
                            self._hidden(params, tokens, cross_ctx=ctx)[0])

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """The cross-entropy of batch["tokens"] against batch["labels"]
        given batch["frames"]."""
        return layers.cross_entropy(
            self.forward(params, batch["tokens"], frames=batch.get("frames")),
            batch["labels"])

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                frames: torch.Tensor | None = None,
                enc_out: torch.Tensor | None = None) -> torch.Tensor:
        ctx = self._context(params, frames, enc_out)
        x, _ = self._hidden(params, tokens, cache=cache, cache_index=0,
                            cross_ctx=ctx)
        return self._logits(params, x[:, -1:])

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index: int,
                    enc_out: torch.Tensor | None = None,
                    frames: torch.Tensor | None = None) -> torch.Tensor:
        ctx = self._context(params, frames, enc_out)
        x, _ = self._hidden(params, tokens, cache=cache, cache_index=index,
                            cross_ctx=ctx)
        return self._logits(params, x)


def build(cfg: ArchConfig, force: str | None = None, remat: str = "full",
          kv_cache_dtype=torch.bfloat16) -> LM:
    """The LM for `cfg`: `WhisperLM` for an encoder-decoder config."""
    cls = WhisperLM if cfg.encdec is not None else LM
    return cls(cfg, force=force, remat=remat, kv_cache_dtype=kv_cache_dtype)
