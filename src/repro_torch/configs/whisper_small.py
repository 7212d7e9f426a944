"""Whisper-small: encoder-decoder, GELU FFN, conv frontend STUB.

[arXiv:2212.04356; unverified]
12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The conv frontend is a stub: the model takes precomputed frame embeddings
(``batch["frames"]``, (B, F, d_model)). num_layers below is the DECODER
depth; the encoder stack is configured via `encoder`.
"""
from repro_torch.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        activation="gelu",
        encoder=EncoderConfig(num_layers=12, num_frames=1500),
        source="arXiv:2212.04356; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        activation="gelu",
        encoder=EncoderConfig(num_layers=2, num_frames=64),
    )
