"""Analytic FLOPs / bytes accounting per (arch x shape) cell.

XLA's cost analysis counts lax.scan bodies once (a while op), so compiled
FLOPs structurally undercount scanned models; the roofline's compute term
therefore uses these closed-form counts (6*N*D style, with explicit
attention/MoE/SSM terms), and the HLO numbers are reported alongside as
diagnostics (EXPERIMENTS.md SS Dry-run notes the discrepancy and the
collective-bytes parser's while-trip correction).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class Accounting:
    flops: float            # total FLOPs for the step (global)
    model_flops: float      # 6*N_active*D (train) / 2*N_active*D (serve)
    hbm_bytes: float        # estimated HBM traffic for the step (global)
    param_bytes: float      # parameter bytes read per step
    param_count: float
    active_param_count: float
    kv_read_bytes: float
    kv_write_bytes: float


def active_params(cfg: ArchConfig) -> float:
    """Params touched per token (MoE: shared + top-k routed only)."""
    if cfg.moe is None:
        return float(cfg.param_count())
    m = cfg.moe
    d = cfg.d_model
    emb = cfg.vocab * d * (1 if cfg.tied_embeddings else 2)
    if cfg.mla is not None:
        a = cfg.mla
        attn = (d * a.q_lora_rank
                + a.q_lora_rank * cfg.n_heads * (a.qk_nope_dim + a.qk_rope_dim)
                + d * (a.kv_lora_rank + a.qk_rope_dim)
                + a.kv_lora_rank * cfg.n_heads * (a.qk_nope_dim + a.v_head_dim)
                + cfg.n_heads * a.v_head_dim * d)
    else:
        attn = 2 * d * cfg.n_heads * cfg.head_dim \
            + 2 * d * cfg.n_kv_heads * cfg.head_dim
    ffn_moe = 3 * d * m.d_expert * (m.top_k + m.n_shared)
    ffn_dense = 3 * d * m.dense_d_ff
    n_moe = cfg.n_layers - m.first_dense_layers
    return float(emb + cfg.n_layers * attn + n_moe * ffn_moe
                 + m.first_dense_layers * ffn_dense)


def _attn_flops(cfg: ArchConfig, batch: int, s_q: int, s_kv: int,
                causal: bool) -> float:
    """SDPA flops: QK^T + PV, 2 MACs each."""
    if cfg.rwkv:
        # WKV recurrence: ~4 state ops of (hd x hd) per head per token
        hd = cfg.d_model // cfg.n_heads
        return 4.0 * batch * s_q * cfg.n_heads * hd * hd * 2
    h = cfg.n_heads
    hd = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) if cfg.mla else cfg.head_dim
    frac = 0.5 if (causal and s_q == s_kv) else 1.0
    base = 4.0 * batch * s_q * s_kv * h * hd * frac
    if cfg.ssm is not None:
        # hybrid: SWA on most layers
        glb = len(cfg.ssm.global_attn_layers)
        swa = cfg.n_layers - glb
        w = min(cfg.ssm.sliding_window, s_kv)
        per_layer = 4.0 * batch * s_q * h * hd
        attn = per_layer * (glb * s_kv * frac + swa * w)
        ssm = 6.0 * batch * s_q * cfg.d_model * cfg.ssm.state_dim * cfg.n_layers
        return attn + ssm
    return base * cfg.n_layers


def account(cfg: ArchConfig, shape: ShapeSpec) -> Accounting:
    n_total = float(cfg.param_count())
    n_active = active_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    is_train = shape.kind == "train"
    tokens = b * (1 if shape.is_decode else s)

    matmul_fwd = 2.0 * tokens * n_active
    if shape.is_decode:
        attn = _attn_flops(cfg, b, 1, s, causal=True)
    else:
        attn = _attn_flops(cfg, b, s, s, causal=True)
    if cfg.encdec is not None and not shape.is_decode:
        # encoder + cross attention over the frame context
        f = cfg.encdec.n_frames
        attn += _attn_flops(cfg, b, f, f, causal=False) \
            + 4.0 * b * s * f * cfg.n_heads * cfg.head_dim * cfg.n_layers

    fwd = matmul_fwd + attn
    mult = 3.0 if is_train else 1.0        # fwd + dgrad + wgrad
    flops = fwd * mult
    if cfg.mtp and is_train:
        flops *= 1.0 + 1.5 / cfg.n_layers  # one extra block + head
    model_flops = (6.0 if is_train else 2.0) * n_active * tokens

    # KV cache traffic (serving)
    kv_read = kv_write = 0.0
    if shape.is_decode:
        if cfg.rwkv:
            state = cfg.n_layers * cfg.n_heads \
                * (cfg.d_model // cfg.n_heads) ** 2 * 2
            kv_read = kv_write = float(b * state * 2)
        elif cfg.mla is not None:
            per_tok = cfg.n_layers * (cfg.mla.kv_lora_rank
                                      + cfg.mla.qk_rope_dim) * 2
            kv_read, kv_write = float(b * s * per_tok), float(b * per_tok)
        elif cfg.ssm is not None:
            w = cfg.ssm.sliding_window
            glb = len(cfg.ssm.global_attn_layers)
            swa = cfg.n_layers - glb
            per_l = cfg.n_kv_heads * cfg.head_dim * 2 * 2
            kv_read = float(b * (glb * s + swa * w) * per_l
                         + b * cfg.n_layers * cfg.d_model
                         * cfg.ssm.state_dim * 4)
            kv_write = float(b * cfg.n_layers * per_l
                         + b * cfg.n_layers * cfg.d_model
                         * cfg.ssm.state_dim * 4)
        else:
            per_l = cfg.n_kv_heads * cfg.head_dim * 2 * 2
            kv_read, kv_write = float(b * s * cfg.n_layers * per_l), \
                float(b * cfg.n_layers * per_l)
    elif shape.kind == "prefill":
        per_l = ((cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
                 if cfg.mla else cfg.n_kv_heads * cfg.head_dim * 2 * 2)
        kv_write = float(b * s * cfg.n_layers * per_l)

    pbytes = n_total * (4.0 if is_train else 2.0)
    act_bytes = 16.0 * cfg.n_layers * tokens * cfg.d_model * 2.0 * \
        (1.0 if is_train else 0.25)
    hbm = pbytes * (6.0 if is_train else 1.0) + act_bytes + kv_read + kv_write
    return Accounting(flops=flops, model_flops=model_flops, hbm_bytes=hbm,
                      param_bytes=pbytes, param_count=n_total,
                      active_param_count=n_active,
                      kv_read_bytes=kv_read, kv_write_bytes=kv_write)
