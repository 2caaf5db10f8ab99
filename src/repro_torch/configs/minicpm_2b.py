"""MiniCPM 2B [arXiv:2404.06395; hf]: llama-like, WSD schedule (wired in
optim/schedules.py), depth-scaled residuals, tied embeddings."""
import math

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
        d_ff=5760, vocab=122753, tied_embeddings=True,
        residual_scale=1.4 / math.sqrt(40),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, tied_embeddings=True,
        residual_scale=1.4 / math.sqrt(2),
    )
