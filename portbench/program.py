"""What the benchmark takes from the program under test, `repro_torch`:
its configuration type, built from a configuration file, and its entry
points.  The reference never imports this module."""

from __future__ import annotations

_ARCH_KEYS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "qk_norm",
              "activation", "rope_theta", "tied_embeddings",
              "residual_scale")
_MOE_KEYS = ("n_experts", "top_k", "d_expert", "n_shared",
             "first_dense_layers", "dense_d_ff", "group_size",
             "capacity_factor")


def arch(cfg: dict):
    """The port's `ArchConfig` for a configuration file."""
    from repro_torch.configs.base import ArchConfig, MoESpec
    moe = cfg.get("moe")
    return ArchConfig(
        **{k: cfg[k] for k in _ARCH_KEYS if k in cfg},
        moe=None if moe is None else MoESpec(**{k: moe[k] for k in _MOE_KEYS}))
