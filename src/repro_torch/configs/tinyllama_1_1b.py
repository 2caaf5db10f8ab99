"""TinyLlama 1.1B [arXiv:2401.02385; hf]: llama2-arch small, GQA kv=4."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
        d_ff=5632, vocab=32000,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
    )
