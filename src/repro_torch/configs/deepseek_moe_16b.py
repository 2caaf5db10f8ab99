"""DeepSeek-MoE 16B [arXiv:2401.06066; hf]: fine-grained MoE, 2 shared +
64 routed top-6 experts, first layer dense."""
from repro_torch.configs.base import ArchConfig, MoESpec


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400,
        moe=MoESpec(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                    first_dense_layers=1, dense_d_ff=10944),
    )


def reduced_config() -> ArchConfig:
    # 2 layers (1 dense + 1 MoE) and 4 experts: keeps the fine-grained
    # routed+shared expert path at the minimum eager op count
    return ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256,
        moe=MoESpec(n_experts=4, top_k=2, d_expert=96, n_shared=1,
                    first_dense_layers=1, dense_d_ff=192, group_size=32,
                    capacity_factor=8.0),
    )
