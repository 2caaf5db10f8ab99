"""Gemma 7B [arXiv:2403.08295; hf]: GeGLU, head_dim=256, MHA (kv=16),
sqrt(d) embedding scale, tied embeddings."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, activation="gelu",
        tied_embeddings=True, embed_scale_by_dim=True, logit_cap=30.0,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256, activation="gelu",
        tied_embeddings=True, embed_scale_by_dim=True, logit_cap=30.0,
    )
