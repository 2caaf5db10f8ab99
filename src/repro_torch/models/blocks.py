"""Architecture blocks, ported from `repro.models.blocks`: the GShard
mixture of experts (DeepSeek-MoE), DeepSeek-V3's multi-head latent
attention (MLA) with its latent cache, the Mamba-style selective SSM of
the Hymba hybrid block, and the RWKV6 (Finch) time-mix with its
data-dependent decay and channel-mix.

Storage follows `layers`: matmul weights (the router and the experts too)
and the `mu_*` token-shift mixes in bf16 for serving (the JAX package casts
them to the activation dtype at every use) or in the init's `dtype` (fp32
masters for training), while the leaves that the JAX blocks read in fp32
stay fp32: the router bias, the SSM's `a_log`, the decay base `w0`, its
LoRA `w_lora_a` / `w_lora_b` and the bonus `u`.

The MoE dispatches by index where the JAX block multiplies by one-hot
tensors; the kept rows, the dropped (token, slot) pairs and the rounding
points are the same.  The WKV recurrence goes through `ops.rwkv_mix` (the
CUDA kernel on the GPU) where the JAX block runs its own `lax.scan`, and
so does the SSM's selective scan, through `ops.ssm_scan` (a `lax.scan`
with no Pallas kernel in the JAX package).  As in the JAX package, the
state handed back between calls (RWKV's `last_x` and WKV state `s`, the
SSM's conv tail and `h`) is bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.layers import Params, _matmul

# ---------------------------------------------------------------------------
# Mixture of experts: GShard groups, capacity drops, shared experts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0           # shared (always-on) experts
    group_size: int = 512       # tokens per dispatch group
    capacity_factor: float = 1.25
    router_bias: bool = True    # aux-loss-free bias (DeepSeek-V3 style)

    @property
    def capacity(self) -> int:
        """Slots per expert and group, as the JAX block computes them."""
        return int(self.group_size * self.top_k / self.n_experts
                   * self.capacity_factor) + 1


def init_moe(generator: torch.Generator, dims: MoEDims,
             dtype=torch.bfloat16) -> Params:
    d, e, f = dims.d_model, dims.n_experts, dims.d_expert
    s_in, s_out = d ** -0.5, f ** -0.5
    tn = layers.truncated_normal
    p = {"router": tn((d, e), s_in, generator, dtype),
         "wi_gate": tn((e, d, f), s_in, generator, dtype),
         "wi_up": tn((e, d, f), s_in, generator, dtype),
         "wo": tn((e, f, d), s_out, generator, dtype)}
    if dims.router_bias:
        p["router_bias"] = torch.zeros(e, dtype=torch.float32,
                                       device=generator.device)
    if dims.n_shared:
        p["shared"] = layers.init_mlp(generator, d, dims.n_shared * f, dtype)
    return p


def group_tokens(x: torch.Tensor, group_size: int):
    """x (B,S,d) flattened row-major and cut into groups (G,group_size,d),
    the last zero-padded; with valid (G,group_size) marking real tokens."""
    b, s, d = x.shape
    t = b * s
    pad = (-t) % group_size
    flat = x.reshape(t, d)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad, d)])
    valid = (torch.arange(t + pad, device=x.device) < t).reshape(
        -1, group_size)
    return flat.reshape(-1, group_size, d), valid


def route(p: Params, dims: MoEDims, xg: torch.Tensor, valid: torch.Tensor):
    """Top-k routing of groups xg (G,S_g,d) with `valid` (G,S_g) marking
    real tokens (`group_tokens`).  Returns (probs (G,S_g,E) fp32; expert (G,S_g,K); gates
    (G,S_g,K) fp32, zero on padding; position (G,S_g,K) of each (token,
    slot) in its expert's buffer; kept (G,S_g,K): valid and within
    capacity; frac (G,E): the share of the group's (token, slot) pairs
    that chose each expert, before the capacity cut).

    The top k are taken by a stable descending sort of `probs +
    router_bias`: on equal values the lower expert first, as
    `jax.lax.top_k`.  The position counts the group's earlier (token,
    slot) pairs that chose the same expert, token-major."""
    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    routed = probs + p["router_bias"] if "router_bias" in p else probs
    expert = torch.sort(routed, dim=-1, descending=True,
                        stable=True).indices[..., :dims.top_k]
    gates = probs.gather(-1, expert)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    gates = gates * valid[..., None]
    n_g, s_g, k = expert.shape
    # one-hot (G,E,S_g*K), (token, slot) pairs token-major on the last,
    # contiguous axis: the count runs along it
    flat = expert.reshape(n_g, 1, s_g * k)
    onehot = (flat == torch.arange(dims.n_experts, device=xg.device)[:, None])
    onehot = onehot & valid.repeat_interleave(k, dim=1)[:, None]
    count = onehot.cumsum(dim=-1, dtype=torch.int32)
    position = count.gather(1, flat).reshape(n_g, s_g, k) - 1
    kept = valid[..., None] & (position < dims.capacity)
    return probs, expert, gates, position, kept, onehot.float().mean(dim=-1)


def moe(p: Params, dims: MoEDims, x: torch.Tensor):
    """Returns (out, aux_loss).  x: (B,S,d); aux fp32.

    (B,S) is flattened row-major and cut into groups of `group_size`
    tokens, the last zero-padded.  Each kept (token, slot) row is gathered
    into an (E, G*C, d) buffer (C = `dims.capacity`; empty slots zero), the
    experts run as batched products over E, and each token sums its kept
    slots' outputs times its gates (rounded to x's dtype) in fp32, rounded
    once.  The load-balance loss is mean_G(sum_E(frac * mean_prob)) * E,
    `frac` from the routing before the capacity cut; padding rows count in
    both means, as in the JAX block."""
    b, s, d = x.shape
    e, cap = dims.n_experts, dims.capacity
    xg, valid = group_tokens(x, dims.group_size)
    n_g, g_size = valid.shape
    n_rows = n_g * g_size
    probs, expert, gates, position, kept, frac = route(p, dims, xg, valid)

    # buffer slot of each (token, slot): expert-major, then group, position
    group = torch.arange(n_g, device=x.device)[:, None, None]
    slot = torch.where(kept, (expert * n_g + group) * cap + position, e * n_g
                       * cap)
    token = torch.arange(n_rows, device=x.device).reshape(n_g, g_size, 1)
    source = torch.full((e * n_g * cap + 1,), n_rows, dtype=torch.long,
                        device=x.device)
    source[slot.reshape(-1)] = token.expand_as(slot).reshape(-1)
    rows = torch.cat([xg.reshape(n_rows, d), xg.new_zeros(1, d)])  # + empty
    exp_in = rows[source[:-1]].reshape(e, n_g * cap, d)

    gate_h = F.silu(torch.bmm(exp_in, p["wi_gate"].to(x.dtype)))
    up_h = torch.bmm(exp_in, p["wi_up"].to(x.dtype))
    exp_out = torch.bmm(gate_h * up_h, p["wo"].to(x.dtype)).reshape(-1, d)

    weight = torch.where(kept, gates, 0.0).to(x.dtype).float()
    picked = exp_out[torch.where(kept, slot, 0)].float()    # (G,S_g,K,d)
    out = (picked * weight[..., None]).sum(dim=2).to(x.dtype)

    aux = (frac * probs.mean(dim=1)).sum(dim=-1).mean() * e
    out = out.reshape(n_rows, d)[:b * s].reshape(b, s, d)
    if "shared" in p:
        out = out + layers.mlp(p["shared"], x)
    return out, aux


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla(generator: torch.Generator, dims: MLADims,
             dtype=torch.bfloat16) -> Params:
    d, h = dims.d_model, dims.n_heads
    r_q, r_kv = dims.q_lora_rank, dims.kv_lora_rank
    tn, dev = layers.truncated_normal, generator.device
    return {
        "wq_a": tn((d, r_q), d ** -0.5, generator, dtype),
        "q_norm": layers.init_rmsnorm(r_q, dev),
        "wq_b": tn((r_q, h, dims.qk_dim), r_q ** -0.5, generator, dtype),
        "wkv_a": tn((d, r_kv + dims.qk_rope_dim), d ** -0.5, generator,
                    dtype),
        "kv_norm": layers.init_rmsnorm(r_kv, dev),
        "wk_b": tn((r_kv, h, dims.qk_nope_dim), r_kv ** -0.5, generator,
                   dtype),
        "wv_b": tn((r_kv, h, dims.v_head_dim), r_kv ** -0.5, generator,
                   dtype),
        "wo": tn((h, dims.v_head_dim, d), (h * dims.v_head_dim) ** -0.5,
                 generator, dtype),
    }


def mla_attention(p: Params, dims: MLADims, x: torch.Tensor,
                  positions: torch.Tensor, *, kv_cache: Params | None = None,
                  cache_index: int | None = None,
                  force: str | None = None) -> torch.Tensor:
    """MLA over the compressed latent: x (B,S,d) -> (B,S,d).  With a cache
    {"ckv": (B,S_max,kv_lora_rank), "krope": (B,S_max,rope)} (`init_mla_cache`)
    the new latents are written in place from `cache_index` on and the
    queries attend over the whole cache, masked causally.  A cache of
    another dtype (fp8 e4m3) is written rounded and read upcast to x's
    dtype, so the kernel never sees fp8 (the JAX package raises there:
    R16).  Attention runs in the absorbed form: q_nope is taken into the latent space through
    `wk_b`, and every head attends against one shared key head [ckv, krope]
    (576 features at DeepSeek-V3's widths) and value head ckv (512).  Below
    `ops.FLASH_THRESHOLD` query positions (decode, short prefills) the
    logits are fp32 and the probabilities are rounded to x's dtype before
    the values; at or above it `ops.attention` (the flash kernel at the
    MLA layout on CUDA tensors, its plain twin on CPU tensors; `force` as
    there), with the scale qk_dim**-0.5."""
    s = x.shape[1]
    nope, r_kv = dims.qk_nope_dim, dims.kv_lora_rank
    scale = dims.qk_dim ** -0.5
    q_lat = layers.rmsnorm(p["q_norm"], _matmul(x, p["wq_a"]))
    q = _matmul(q_lat, p["wq_b"])                        # (B,S,H,qk_dim)
    q_rope = layers.apply_rope(q[..., nope:], positions, dims.rope_theta)
    kv_a = _matmul(x, p["wkv_a"])
    ckv = layers.rmsnorm(p["kv_norm"], kv_a[..., :r_kv])
    krope = layers.apply_rope(kv_a[..., None, r_kv:], positions,
                              dims.rope_theta)[:, :, 0]
    q_offset = 0
    if kv_cache is not None:   # written rounded to the cache's dtype,
        for name, t in (("ckv", ckv), ("krope", krope)):   # read upcast
            kv_cache[name][:, cache_index:cache_index + s] = t.to(
                kv_cache[name].dtype)
        ckv, krope = (kv_cache[n].to(x.dtype) for n in ("ckv", "krope"))
        q_offset = cache_index
    q_abs = torch.einsum("bqhd,rhd->bqhr", q[..., :nope],
                         p["wk_b"].to(x.dtype))
    q_eff = torch.cat([q_abs, q_rope], dim=-1)           # (B,S,H,r_kv+rope)
    k_eff = torch.cat([ckv, krope], dim=-1)[:, :, None]  # (B,S_kv,1,...)
    if s < ops.FLASH_THRESHOLD:
        logits = torch.einsum("bqhr,bkr->bhqk", q_eff.float(),
                              k_eff[:, :, 0].float()) * scale
        q_pos = torch.arange(s, device=x.device) + q_offset
        k_pos = torch.arange(ckv.shape[1], device=x.device)
        logits = logits.masked_fill(q_pos[:, None] < k_pos[None, :],
                                    ref.NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        dt = torch.promote_types(probs.dtype, ckv.dtype)
        ctx = torch.einsum("bhqk,bkr->bqhr", probs.to(dt), ckv.to(dt))
    else:
        dt = torch.promote_types(q_eff.dtype, k_eff.dtype)
        k_eff = k_eff.to(dt)
        ctx = ops.attention(q_eff.to(dt), k_eff, k_eff[..., :r_kv],
                            causal=True, q_offset=q_offset, scale=scale,
                            force=force).to(x.dtype)
    v = torch.einsum("bqhr,rhd->bqhd", ctx,
                     p["wv_b"].to(x.dtype).to(ctx.dtype))
    return _matmul(v, p["wo"], n_in=2)


def init_mla_cache(batch: int, max_seq: int, dims: MLADims, device,
                   dtype=torch.bfloat16) -> Params:
    """The latent cache in `dtype` (bf16, or fp8 e4m3 at half the bytes),
    written in place by `mla_attention`."""
    return {"ckv": torch.zeros((batch, max_seq, dims.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, dims.qk_rope_dim),
                                 dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Selective SSM (Mamba-style), the SSM half of Hymba's hybrid block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    state_dim: int = 16
    conv_k: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def init_ssm(generator: torch.Generator, dims: SSMDims,
             dtype=torch.bfloat16) -> Params:
    d, di, n, dev = dims.d_model, dims.d_inner, dims.state_dim, \
        generator.device
    tn = layers.truncated_normal
    return {
        "in_proj": tn((d, 2 * di), d ** -0.5, generator, dtype),
        "conv": tn((dims.conv_k, di), 0.5, generator, dtype),
        "x_proj": tn((di, dims.dtr + 2 * n), di ** -0.5, generator, dtype),
        "dt_proj": tn((dims.dtr, di), dims.dtr ** -0.5, generator, dtype),
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "d_skip": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": tn((di, d), di ** -0.5, generator, dtype),
    }


def depthwise_conv(conv_in: torch.Tensor, kern: torch.Tensor):
    """The causal depthwise conv as the JAX block writes it: conv_in
    (B,S+K-1,di) and kern (K,di) of one dtype, out[:, t] = sum_i
    conv_in[:, t + i] * kern[i], each product and partial sum rounded to
    that dtype, in the order i = 0..K-1."""
    kw = kern.shape[0]
    s = conv_in.shape[1] - kw + 1
    u = conv_in[:, :s] * kern[0]
    for i in range(1, kw):
        u = u + conv_in[:, i:i + s] * kern[i]
    return u


def ssm(p: Params, dims: SSMDims, x: torch.Tensor, *,
        state: Params | None = None, force: str | None = None):
    """Selective scan.  x: (B,S,d); state: {"conv": (B,K-1,di), "h":
    (B,di,N)} or None (zeros).  `force` goes to `ops.ssm_scan`.  Returns
    (out, new_state), the state bf16.

    The rounding follows the JAX block: the depthwise conv is a sum of K
    products in x's dtype, each product and partial sum rounded, in the
    order i = 0..K-1 (not a conv1d, which accumulates in fp32); dt, B, C,
    the decay and the drive are fp32, and so is the scan; y is rounded to
    x's dtype before the skip and the gate.  The scan is one kernel launch
    on CUDA tensors (decay and drive formed in registers) and the plain
    loop over tokens on the CPU."""
    b, s, _ = x.shape
    di, n, kw = dims.d_inner, dims.state_dim, dims.conv_k
    ux, z = _matmul(x, p["in_proj"]).chunk(2, dim=-1)
    head = (ux.new_zeros(b, kw - 1, di) if state is None
            else state["conv"].to(ux.dtype))
    conv_in = torch.cat([head, ux], dim=1)
    u = F.silu(depthwise_conv(conv_in, p["conv"].to(ux.dtype)))

    proj = _matmul(u, p["x_proj"])
    dt = F.softplus(_matmul(proj[..., :dims.dtr], p["dt_proj"]).float())
    bmat = proj[..., dims.dtr:dims.dtr + n].float()          # (B,S,N)
    cmat = proj[..., dims.dtr + n:].float()                  # (B,S,N)
    a = -torch.exp(p["a_log"].float())                       # (di,N)
    y, h = ops.ssm_scan(dt, u.float(), bmat, cmat, a,
                        None if state is None else state["h"].float(),
                        force=force)
    y = y.to(u.dtype) + u * p["d_skip"].to(u.dtype)          # (B,S,di)
    out = _matmul(y * F.silu(z), p["out_proj"])
    return out, {"conv": conv_in[:, s:].to(torch.bfloat16),
                 "h": h.to(torch.bfloat16)}


def init_ssm_state(batch: int, dims: SSMDims, device) -> Params:
    return {"conv": torch.zeros(batch, dims.conv_k - 1, dims.d_inner,
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros(batch, dims.d_inner, dims.state_dim,
                             dtype=torch.bfloat16, device=device)}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKVDims:
    d_model: int
    n_heads: int           # head_dim = d_model // n_heads
    d_ff: int
    decay_lora: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_rwkv_tmix(generator: torch.Generator, dims: RWKVDims,
                   dtype=torch.bfloat16) -> Params:
    d, dev = dims.d_model, generator.device
    s = d ** -0.5
    tn = layers.truncated_normal

    def mix():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)
    return {
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_w": mix(),
        "wr": tn((d, d), s, generator, dtype),
        "wk": tn((d, d), s, generator, dtype),
        "wv": tn((d, d), s, generator, dtype),
        "wg": tn((d, d), s, generator, dtype),
        "w0": torch.full((d,), -5.0, dtype=torch.float32, device=dev),
        "w_lora_a": tn((d, dims.decay_lora), s, generator, torch.float32),
        "w_lora_b": tn((dims.decay_lora, d), dims.decay_lora ** -0.5,
                       generator, torch.float32),
        "bonus": torch.zeros((dims.n_heads, dims.head_dim),
                             dtype=torch.float32, device=dev),
        "ln_out": layers.init_rmsnorm(d, dev),
        "wo": tn((d, d), s, generator, dtype),
    }


def _shifted(x: torch.Tensor, state: Params | None) -> torch.Tensor:
    """x moved one token later; position 0 gets the carried `last_x`."""
    last = (torch.zeros_like(x[:, 0]) if state is None
            else state["last_x"].to(x.dtype))
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def rwkv_tmix(p: Params, dims: RWKVDims, x: torch.Tensor, *,
              state: Params | None = None, force: str | None = None):
    """WKV6 time-mix.  x: (B,S,d); state: {"last_x": (B,d),
    "s": (B,H,hd,hd)} or None.  `force` goes to `ops.rwkv_mix`.
    Returns (out, new_state), the state in bf16."""
    b, s_len, d = x.shape
    h, hd = dims.n_heads, dims.head_dim
    x_prev = _shifted(x, state)

    def mix(mu):
        return x + (x_prev - x) * mu.to(x.dtype)

    r = _matmul(mix(p["mu_r"]), p["wr"])
    k = _matmul(mix(p["mu_k"]), p["wk"])
    v = _matmul(mix(p["mu_v"]), p["wv"])
    g = F.silu(_matmul(x, p["wg"]))
    # data-dependent decay, in fp32
    w_in = mix(p["mu_w"]).float()
    w = p["w0"] + (w_in @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w))

    heads = (b, s_len, h, hd)
    y, s_last = ops.rwkv_mix(
        r.reshape(heads).float(), k.reshape(heads).float(),
        v.reshape(heads).float(), w.reshape(heads), p["bonus"],
        s0=None if state is None else state["s"].float(), force=force)
    y = y.reshape(b, s_len, d).to(x.dtype)
    y = layers.rmsnorm(p["ln_out"], y) * g
    out = _matmul(y, p["wo"])
    return out, {"last_x": x[:, -1].to(torch.bfloat16),
                 "s": s_last.to(torch.bfloat16)}


def init_rwkv_cmix(generator: torch.Generator, dims: RWKVDims,
                   dtype=torch.bfloat16) -> Params:
    d = dims.d_model
    return {
        "mu": torch.full((d,), 0.5, dtype=dtype, device=generator.device),
        "wk": layers.truncated_normal((d, dims.d_ff), d ** -0.5, generator,
                                      dtype),
        "wv": layers.truncated_normal((dims.d_ff, d), dims.d_ff ** -0.5,
                                      generator, dtype),
    }


def rwkv_cmix(p: Params, dims: RWKVDims, x: torch.Tensor, *,
              state: Params | None = None):
    """Squared-ReLU channel-mix with token shift.  Returns (out,
    {"last_x": (B,d) bf16})."""
    xm = x + (_shifted(x, state) - x) * p["mu"].to(x.dtype)
    k = torch.square(torch.relu(_matmul(xm, p["wk"])))
    return (_matmul(k, p["wv"]),
            {"last_x": x[:, -1].to(torch.bfloat16)})


def init_rwkv_state(batch: int, dims: RWKVDims, device) -> Params:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return {"tmix": {"last_x": z(batch, dims.d_model),
                     "s": z(batch, dims.n_heads, dims.head_dim,
                            dims.head_dim)},
            "cmix": {"last_x": z(batch, dims.d_model)}}
