"""Llama-2 7B: the paper's primary evaluation model (dense SwiGLU).

32L d_model=4096 32H (kv=32) d_ff=11008 vocab=32000.
Used by the benchmark suite as the reference conversion target family.
"""
from repro_torch.config import CMoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=32000,
        activation="swiglu",
        rope_theta=10000.0,
        source="arXiv:2307.09288",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        activation="swiglu",
    )


def paper_cmoe() -> CMoEConfig:
    """S3A3E8 @ 25% sparsity, K_a=10, 8x2048 calibration tokens."""
    return CMoEConfig(num_experts=8, num_shared=3, top_k=3,
                      k_activation=10, calib_tokens=16384)
