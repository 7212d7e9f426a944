"""InternVL2-26B: InternViT (STUB) + InternLM2-20B language backbone.

[arXiv:2404.16821; hf]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision tower is a stub per the assignment: input_specs() provides
precomputed patch embeddings prepended to the token sequence.
"""
from repro_torch.config import ModelConfig, VisionConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        activation="swiglu",
        rope_theta=1000000.0,
        vision=VisionConfig(num_patches=256, d_patch=0),
        source="arXiv:2404.16821; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        vision=VisionConfig(num_patches=8, d_patch=0),
    )
