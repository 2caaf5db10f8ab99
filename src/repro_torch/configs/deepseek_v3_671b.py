"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA, 1 shared + 256 routed
top-8 experts, MTP, 3 leading dense layers."""
from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=2048, vocab=129280, mtp=True,
        mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512,
                    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoESpec(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                    first_dense_layers=3, dense_d_ff=18432),
    )


def reduced_config() -> ArchConfig:
    # 2 layers (1 dense + 1 MoE) and 4 experts: the smallest shape that
    # still exercises the MLA, routed+shared expert, and MTP paths — eager
    # smoke-test cost scales with op count, not parameter size
    return ArchConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=256, mtp=True,
        mla=MLASpec(q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoESpec(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                    first_dense_layers=1, dense_d_ff=128, group_size=32,
                    capacity_factor=8.0),
    )
