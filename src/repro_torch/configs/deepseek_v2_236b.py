"""DeepSeek-V2 236B: MLA attention (kv_lora=512) + MoE 160e top-6, 2 shared.

[arXiv:2405.04434; hf]
60L d_model=5120 128H (GQA kv=128) d_expert=1536 vocab=102400.
All layers MoE (release has 1 leading dense layer; see DESIGN.md).
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        activation="swiglu",
        rope_theta=10000.0,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_expert=1536,
            num_shared=2,
            d_shared=3072,           # 2 shared experts x 1536
        ),
        source="arXiv:2405.04434; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        activation="swiglu",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=96,
                      num_shared=2, d_shared=192),
    )
