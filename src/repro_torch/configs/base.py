"""Config dataclasses shared by all architectures + the assigned shapes."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense_layers: int = 0   # leading dense layers (DeepSeek style)
    dense_d_ff: int = 0           # d_ff of those dense layers
    group_size: int = 512
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    state_dim: int = 16
    conv_k: int = 4
    # hybrid (Hymba): indices of global-attention layers; others use SWA
    global_attn_layers: tuple[int, ...] = ()
    sliding_window: int = 1024


@dataclasses.dataclass(frozen=True)
class EncDecSpec:
    n_encoder_layers: int
    n_frames: int = 1500          # stub frontend: precomputed embeddings


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    activation: str = "silu"      # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    tied_embeddings: bool = False
    embed_scale_by_dim: bool = False   # Gemma-style sqrt(d) embed scale
    residual_scale: float = 1.0        # MiniCPM depth scaling
    logit_cap: float = 0.0
    mtp: bool = False                  # DeepSeek-V3 multi-token prediction
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    rwkv: bool = False
    encdec: Optional[EncDecSpec] = None

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.rwkv or self.ssm is not None

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tied_embeddings else 2)
        if self.rwkv:
            block = 6 * d * d + 2 * d * self.d_ff
        elif self.mla is not None:
            m = self.mla
            attn = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_dim + m.qk_rope_dim)
            attn += d * (m.kv_lora_rank + m.qk_rope_dim)
            attn += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            attn += self.n_heads * m.v_head_dim * d
            block = attn
        else:
            attn = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2
            block = attn
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_expert * (self.moe.n_experts
                                               + self.moe.n_shared)
        elif not self.rwkv:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 0
        if self.ssm is not None:
            ffn += 3 * d * d  # in/out projections of the SSM branch
        return emb + l * (block + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
