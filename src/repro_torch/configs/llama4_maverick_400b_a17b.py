"""Llama-4 Maverick 400B-A17B: MoE, 128 experts top-1 + 1 shared.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Early-fusion multimodal in the release; assigned shapes are LM-only so we
model the text backbone. All layers MoE (see DESIGN.md deviations).
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        activation="swiglu",
        rope_theta=500000.0,
        moe=MoEConfig(
            num_experts=128,
            top_k=1,
            d_expert=8192,
            num_shared=1,
            d_shared=8192,
            moe_every=2,             # alternating dense/MoE (real Maverick)
        ),
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        moe=MoEConfig(num_experts=8, top_k=1, d_expert=128,
                      num_shared=1, d_shared=128, moe_every=2),
    )
