"""Hymba 1.5B [arXiv:2411.13676; hf]: parallel attention + Mamba heads,
global attention in 3 layers (first/middle/last), SWA elsewhere."""
from repro_torch.configs.base import ArchConfig, SSMSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001,
        ssm=SSMSpec(state_dim=16, global_attn_layers=(0, 15, 31),
                    sliding_window=1024),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        ssm=SSMSpec(state_dim=4, global_attn_layers=(0, 2),
                    sliding_window=16),
    )
