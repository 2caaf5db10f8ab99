"""Whisper small [arXiv:2212.04356]: encoder-decoder; conv frontend is a
stub (input_specs provides precomputed 1500-frame embeddings)."""
from repro_torch.configs.base import ArchConfig, EncDecSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=51865, activation="gelu",
        encdec=EncDecSpec(n_encoder_layers=12, n_frames=1500),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, activation="gelu",
        encdec=EncDecSpec(n_encoder_layers=2, n_frames=32),
    )
