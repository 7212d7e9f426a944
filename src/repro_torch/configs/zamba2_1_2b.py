"""Zamba2 1.2B: hybrid Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared attention+FFN block reuses ONE set of weights at every
insertion point (Zamba's parameter-sharing trick).
"""
from repro_torch.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        activation="swiglu",
        ssm=SSMConfig(state_size=64, head_dim=64, expand=2,
                      conv_width=4, chunk_size=256),
        hybrid_attn_every=6,
        source="arXiv:2411.15242; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        ssm=SSMConfig(state_size=16, head_dim=16, expand=2,
                      conv_width=4, chunk_size=16),
        hybrid_attn_every=2,
    )
