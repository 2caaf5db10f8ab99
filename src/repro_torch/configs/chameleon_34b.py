"""Chameleon 34B [arXiv:2405.09818]: early-fusion VLM; VQ image tokens are
regular vocab entries (stub tokenizer), qk-norm backbone."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=65536, qk_norm=True,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True,
    )
