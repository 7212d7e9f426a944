"""IBM Granite 34B code model: dense, extreme-GQA/MQA (1 kv head).

[arXiv:2405.04324; hf]
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
The assignment tags it "llama-arch" but the published 34B checkpoint is a
gpt_bigcode-family model: MQA (kv=1) + GELU 2-matrix FFN. With SwiGLU the
parameter count would be 47B; with GELU it is 34.0B — we follow the
parameter count (activation="gelu"). CMoE's gelu path handles it.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        activation="gelu",
        rope_theta=10000.0,
        source="arXiv:2405.04324; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        activation="gelu",
    )
