"""Architecture registry. Each module exposes config() and smoke_config().

The port lists every arch of the JAX package, but only the dense GQA
SwiGLU family runs here so far; the others raise until their slice lands.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# arch id -> module name, for the archs the port runs
ARCHS = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    # the paper's own evaluation model (dense llama-2 family)
    "llama2-7b": "llama2_7b",
}

# archs of the JAX package whose families the port does not run yet
NOT_PORTED = (
    "llama4-maverick-400b-a17b", "deepseek-v2-236b", "granite-34b",
    "gemma3-4b", "phi3-medium-14b", "whisper-small", "zamba2-1.2b",
    "mamba2-370m", "internvl2-26b",
)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; "
                                  f"the port runs {sorted(ARCHS)}")
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
