"""Mamba2 370M: attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1024 vocab=50280, ssm_state=128, d_ff=0 (no FFN).
CMoE is inapplicable to the SSD mixer (no gated neuron basis); the arch
ships without the technique by default — see DESIGN.md §Arch-applicability.
"""
from repro_torch.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        activation="swiglu",
        tie_embeddings=True,
        ssm=SSMConfig(state_size=128, head_dim=64, expand=2,
                      conv_width=4, chunk_size=256),
        source="arXiv:2405.21060; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        tie_embeddings=True,
        ssm=SSMConfig(state_size=16, head_dim=16, expand=2,
                      conv_width=4, chunk_size=16),
    )
