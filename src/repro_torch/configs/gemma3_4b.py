"""Gemma-3 4B: dense, 5:1 local(sliding-1024):global attention, 262k vocab.

[hf:google/gemma-3-1b-pt; unverified]
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, GEGLU.
Sub-quadratic-ish at long context: 5/6 of layers are sliding-window.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        activation="geglu",
        tie_embeddings=True,
        rope_theta=1000000.0,
        sliding_window=1024,
        local_global_ratio=5,
        source="hf:google/gemma-3-1b-pt; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        num_layers=6,                 # one 5:1 period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        activation="geglu",
        tie_embeddings=True,
        sliding_window=16,
        local_global_ratio=5,
    )
