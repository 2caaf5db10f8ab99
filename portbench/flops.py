"""Frozen operation and byte counts, and the peaks of one NVIDIA H100.

Counts are closed forms of a configuration file's sizes (the dicts under
`configs/`), so nothing here reads the program.  They follow the port's
`launch/flops.py` with one correction: a prefill unembeds only each
sequence's last position, as `LM.prefill` does, so it counts 2 d V FLOPs a
sequence and not a token.  Model FLOPs count each matrix product once
(2 FLOPs a multiply-add); remat's recomputation is not counted.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM5 at 700 W: dense bf16 tensor-core rate, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def _moe(cfg: dict) -> dict | None:
    return cfg.get("moe")


def block_params(cfg: dict) -> dict:
    """Matrix-product parameters a token passes through, by kind of layer:
    {"attn": per layer, "mlp": per dense layer, "moe_active": per MoE layer
    (router, top_k routed and the shared experts), "n_dense", "n_moe"}."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    attn = 2 * d * h * hd + 2 * d * kv * hd
    moe = _moe(cfg)
    if moe is None:
        return {"attn": attn, "mlp": 3 * d * cfg["d_ff"], "moe_active": 0,
                "n_dense": cfg["n_layers"], "n_moe": 0}
    lead = moe["first_dense_layers"]
    active = (d * moe["n_experts"]
              + 3 * d * moe["d_expert"] * (moe["top_k"] + moe["n_shared"]))
    return {"attn": attn, "mlp": 3 * d * moe["dense_d_ff"],
            "moe_active": active, "n_dense": lead,
            "n_moe": cfg["n_layers"] - lead}


def non_embedding_active_params(cfg: dict) -> int:
    """Parameters of the blocks' matrix products that one token uses."""
    p = block_params(cfg)
    return (cfg["n_layers"] * p["attn"] + p["n_dense"] * p["mlp"]
            + p["n_moe"] * p["moe_active"])


def unembed_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab"]


def attention_pairs(sq: int, skv: int, causal: bool) -> float:
    """(query, key) pairs a causal call over equal lengths computes: S^2/2,
    the count the port's bounds use."""
    return sq * skv / 2 if causal and sq == skv else float(sq * skv)


def attention_flops(b: int, sq: int, skv: int, h: int, hd: int,
                    causal: bool = True) -> float:
    """QK^T and PV: 2 products of 2 FLOPs a multiply-add."""
    return 4.0 * b * h * hd * attention_pairs(sq, skv, causal)


def attention_bwd_flops(b: int, sq: int, skv: int, h: int, hd: int,
                        causal: bool = True) -> float:
    """dV, dP, dQ, dK and the recomputed S: 2.5 times the forward."""
    return 2.5 * attention_flops(b, sq, skv, h, hd, causal)


def attention_bytes(b: int, sq: int, skv: int, h: int, hd: int,
                    elsize: int, lse: bool) -> float:
    """q, k, v read once, o written once, and lse (fp32) where written."""
    return (elsize * (2 * b * sq * h * hd + 2 * b * skv * h * hd)
            + (4 * b * h * sq if lse else 0))


def attention_bwd_bytes(b: int, sq: int, skv: int, h: int, hd: int,
                        elsize: int) -> float:
    """q, k, v, o, dO and lse read once; dq, dk, dv written once."""
    return (elsize * (4 * b * sq * h * hd + 4 * b * skv * h * hd)
            + 4 * b * h * sq)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def _layers_attention(cfg: dict, b: int, s: int) -> float:
    return cfg["n_layers"] * attention_flops(b, s, s, cfg["n_heads"],
                                             cfg["head_dim"])


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """6 N D for the blocks and the unembedding, plus causal attention's
    forward times 3."""
    n = non_embedding_active_params(cfg) + unembed_params(cfg)
    return 6.0 * n * batch * seq + 3.0 * _layers_attention(cfg, batch, seq)


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """2 N D for the blocks, 2 d V for each sequence's last position, and
    causal attention."""
    return (2.0 * non_embedding_active_params(cfg) * batch * seq
            + 2.0 * unembed_params(cfg) * batch
            + _layers_attention(cfg, batch, seq))
