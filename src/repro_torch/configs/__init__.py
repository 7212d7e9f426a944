"""Architecture registry. Each module exposes config() and smoke_config().

The port lists and runs every arch of the JAX package: the dense GQA
decoders (SwiGLU, gemma3's GEGLU with sliding windows, granite's GELU
MQA), internvl2's VLM (dense blocks behind a patch prefix), deepseek-v2's
MLA + pretrained MoE, llama4's interleaved dense / GQA-MoE stack, the
Mamba2 SSM and zamba2 hybrid families, and whisper-small's
encoder-decoder.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# arch id -> module name, for the archs the port runs
ARCHS = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    # the paper's own evaluation model (dense llama-2 family)
    "llama2-7b": "llama2_7b",
    # multi-head latent attention + the pretrained top-6-of-160 MoE
    "deepseek-v2-236b": "deepseek_v2_236b",
    # dense and GQA + MoE (128 experts top-1, 1 shared) layers interleaved
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    # attention-free Mamba2 (SSD) and the Mamba2 + shared-attention hybrid
    "mamba2-370m": "mamba2_370m",
    "zamba2-1.2b": "zamba2_1_2b",
    # the other dense decoders: SwiGLU GQA; GEGLU with 5:1 local:global
    # sliding windows and a tied 262k head; GELU MQA (one kv head)
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-4b": "gemma3_4b",
    "granite-34b": "granite_34b",
    # dense blocks behind a prefix of (stub) vision patch embeddings
    "internvl2-26b": "internvl2_26b",
    # encoder-decoder: GELU blocks, cross-attention over (stub) frame
    # embeddings
    "whisper-small": "whisper_small",
}

# archs of the JAX package whose families the port does not run: none
NOT_PORTED = ()


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs(include_extra: bool = False) -> list[str]:
    names = list(ARCHS)
    if not include_extra:
        names.remove("llama2-7b")
    return names
