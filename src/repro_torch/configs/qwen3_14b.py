"""Qwen3 14B [hf:Qwen/Qwen3-8B family; hf]: qk-norm, GQA kv=8."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True,
    )
