"""Shared transformer layers, ported from `repro.models.layers`.

Conventions:
  * params are nested dicts of tensors.  For serving, matmul weights are
    stored in bf16 (the JAX package keeps fp32 masters and casts them to
    the activation dtype at every use, so bf16 storage gives the same bf16
    products); for training they are fp32 masters, as in the JAX package
    (the init functions take a `dtype`).  Norm scales stay fp32.  Weights
    are cast to the activation dtype at use, so fp32 activations run in
    fp32.
  * activations are bf16; norms, RoPE and the attention / unembedding
    logits are computed in fp32 (the JAX `preferred_element_type=f32`
    sites upcast their bf16 operands rather than round a bf16 product).
  * the KV cache is updated in place (slice assignment), unlike the JAX
    package's functional updates.  A sliding window shorter than the
    cache is a ring buffer of `window` slots with each slot's absolute
    position (-1: unwritten), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch._guards import detect_fake_mode

from repro_torch.kernels import ops, ref

Params = dict


class DeviceOnly:
    """Stands for the generator of an init where nothing is drawn: the
    shape-only init under a fake mode (`LM.init(..., device=)`).  It names
    the device the init functions place their tensors on."""

    def __init__(self, device):
        self.device = torch.device(device)


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times `scale`, drawn in fp32
    on the generator's device and stored in `dtype` (bf16: a matmul
    weight).  Scaled in place: one fp32 copy at a time (DeepSeek-V3's
    expert weights are 15 GB of it a tensor).  Under a fake mode
    (`torch._subclasses.FakeTensorMode`) nothing is drawn: an empty tensor
    of the shape and dtype, as `jax.eval_shape` of the JAX init gives."""
    if detect_fake_mode() is not None:
        return torch.empty(shape, dtype=dtype, device=generator.device)
    if isinstance(generator, DeviceOnly):
        raise ValueError("truncated_normal: no generator to draw from "
                         "outside a fake mode")
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract x's last `n_in` dims with w's first `n_in` dims."""
    lead, out = x.shape[:x.dim() - n_in], w.shape[n_in:]
    y = x.reshape(*lead, -1) @ w.to(x.dtype).reshape(-1, out.numel())
    return y.reshape(*lead, *out)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs        # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / sliding window / KV cache decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None      # sliding-window size (None = global)
    softmax_scale: float | None = None


def init_attention(generator: torch.Generator, dims: AttnDims,
                   dtype=torch.bfloat16) -> Params:
    d, h, kvh, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    s = d ** -0.5
    p = {
        "wq": truncated_normal((d, h, hd), s, generator, dtype),
        "wk": truncated_normal((d, kvh, hd), s, generator, dtype),
        "wv": truncated_normal((d, kvh, hd), s, generator, dtype),
        "wo": truncated_normal((h, hd, d), (h * hd) ** -0.5, generator,
                               dtype),
    }
    if dims.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, generator.device)
        p["k_norm"] = init_rmsnorm(hd, generator.device)
    return p


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating groups (GQA)."""
    reps = n_heads // k.shape[-2]
    if reps == 1:
        return k
    return torch.repeat_interleave(k, reps, dim=-2)


def _grouped_decode_attention(q, ck, cv, *, cache_index: int,
                              window: int | None, k_positions=None,
                              scale=None):
    """Single-token GQA decode without expanding kv to query heads.

    q: (B,1,H,hd); ck/cv: (B,S,KV,hd).  Without `k_positions` slot i holds
    position i, and the decode attends to slots [max(0, cache_index -
    window + 1), cache_index]: the slice holds exactly the keys the JAX
    version leaves unmasked.  With `k_positions` (S,) int32, the ring
    buffer's absolute position of each slot (-1: unwritten), every slot is
    read and masked on the device as the JAX `attention_scores` masks it.
    Logits in fp32."""
    b, _, h, hd = q.shape
    g = ck.shape[2]
    rep = h // g
    scale = hd ** -0.5 if scale is None else scale
    if k_positions is None:
        lo = 0 if window is None else max(0, cache_index - window + 1)
        ck = ck[:, lo:cache_index + 1]
        cv = cv[:, lo:cache_index + 1]
    qg = q.reshape(b, 1, g, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck.float()) * scale
    if k_positions is not None:
        seen = (k_positions >= 0) & (k_positions <= cache_index)
        if window is not None:
            seen &= k_positions > cache_index - window
        logits = logits.masked_fill(~seen, ref.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cv.to(q.dtype))
    return out.reshape(b, 1, h, hd)


def attention(p: Params, dims: AttnDims, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              kv_cache: Params | None = None, cache_index: int | None = None,
              force: str | None = None) -> torch.Tensor:
    """Full attention op.  Training/prefill when x holds several positions;
    decode when x is (B,1,d) and a cache {"k","v"} (a ring buffer also
    holds "pos") with the fill index is given.  The cache is written in
    place: a prefill stores its keys from `cache_index` on, a ring buffer
    its last `span` keys at their positions mod `span`.  `force` goes to
    `ops.attention` on the prefill path."""
    s = x.shape[1]
    q = _matmul(x, p["wq"])
    k = _matmul(x, p["wk"])
    v = _matmul(x, p["wv"])
    if dims.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)

    if kv_cache is not None and s == 1:
        pos = kv_cache.get("pos")
        slot = cache_index if pos is None else cache_index % pos.shape[0]
        kv_cache["k"][:, slot:slot + 1] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][:, slot:slot + 1] = v.to(kv_cache["v"].dtype)
        if pos is not None:
            pos[slot] = cache_index
        out = _grouped_decode_attention(
            q, kv_cache["k"], kv_cache["v"], cache_index=cache_index,
            window=dims.window, k_positions=pos, scale=dims.softmax_scale)
    else:   # the fresh k and v, never the cache, reach the kernel
        out = ops.attention(
            q, _expand_kv(k, dims.n_heads), _expand_kv(v, dims.n_heads),
            causal=causal, window=dims.window, q_offset=cache_index or 0,
            scale=dims.softmax_scale, force=force)
        if kv_cache is not None:
            base = cache_index or 0
            pos = kv_cache.get("pos")
            ck, cv = k.to(kv_cache["k"].dtype), v.to(kv_cache["v"].dtype)
            if pos is None:
                kv_cache["k"][:, base:base + s] = ck
                kv_cache["v"][:, base:base + s] = cv
            else:   # ring buffer: keep the last `span` keys
                keep = min(s, pos.shape[0])
                kept = base + s - keep + torch.arange(
                    keep, dtype=torch.int32, device=x.device)
                idx = kept.long() % pos.shape[0]
                kv_cache["k"][:, idx] = ck[:, s - keep:]
                kv_cache["v"][:, idx] = cv[:, s - keep:]
                pos[idx] = kept
    return _matmul(out, p["wo"], n_in=2)


def init_kv_cache(batch: int, max_seq: int, dims: AttnDims,
                  device, dtype=torch.bfloat16) -> Params:
    """KV cache in `dtype` (bf16, or fp8 e4m3 at half the bytes) of
    min(max_seq, window) slots per layer; a window shorter than `max_seq`
    makes it a ring buffer, with "pos" the int32 absolute position held in
    each slot (-1: unwritten)."""
    span = max_seq if dims.window is None else min(max_seq, dims.window)
    shape = (batch, span, dims.n_kv_heads, dims.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if span < max_seq:
        cache["pos"] = torch.full((span,), -1, dtype=torch.int32,
                                  device=device)
    return cache


# ---------------------------------------------------------------------------
# Gated MLPs (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16) -> Params:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "wi_gate": truncated_normal((d_model, d_ff), s_in, generator, dtype),
        "wi_up": truncated_normal((d_model, d_ff), s_in, generator, dtype),
        "wo": truncated_normal((d_ff, d_model), s_out, generator, dtype),
    }


_ACTIVATIONS = {"silu": F.silu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


def mlp(p: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    gate = _ACTIVATIONS[activation](_matmul(x, p["wi_gate"]))
    up = _matmul(x, p["wi_up"])
    return _matmul(gate * up, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(generator: torch.Generator, vocab: int, d_model: int,
               tied: bool = True, dtype=torch.bfloat16) -> Params:
    s = d_model ** -0.5
    p = {"table": truncated_normal((vocab, d_model), s, generator, dtype)}
    if not tied:
        p["unembed"] = truncated_normal((d_model, vocab), s, generator, dtype)
    return p


def scalar_as(value: float, dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: multiplying a
    tensor of that dtype by it matches the JAX `x * jnp.asarray(value,
    dtype)` without creating a device tensor (a blocking copy)."""
    return torch.tensor(value, dtype=dtype).item()


def embed(p: Params, tokens: torch.Tensor, scale: float = 1.0,
          dtype=torch.bfloat16) -> torch.Tensor:
    x = p["table"][tokens].to(dtype)
    return x if scale == 1.0 else x * scalar_as(scale, dtype)


def unembed(p: Params, x: torch.Tensor, cap: float | None = None):
    """fp32 logits from fp32-upcast operands, the weight first cast to x's
    dtype as in the JAX package (the product is never rounded to bf16)."""
    table = p.get("unembed")
    w = p["table"].T if table is None else table
    logits = x.float() @ w.to(x.dtype).float()
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy in fp32 with a z-loss regularizer
    (z_loss * logsumexp^2)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = logz - ll
    if z_loss:
        loss = loss + z_loss * logz.square()
    return loss.mean()
