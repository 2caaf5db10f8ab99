"""RWKV6 (Finch) 3B [arXiv:2404.05892; hf]: attention-free, data-dependent
decay WKV recurrence."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, rwkv=True,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, rwkv=True,
    )
