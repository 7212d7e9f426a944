"""Qwen-1.5 0.5B: dense with QKV bias, MHA (kv=16).

[hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
This is also our end-to-end training example model (~100M-class reduced).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151936,
        activation="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=176,
        vocab_size=256,
        activation="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
    )
