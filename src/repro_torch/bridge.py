"""Carry the JAX package's parameters into the port.

The JAX reference keeps parameters as a nested dict pytree; the port keeps
the same layout (stacked (L, ...) block leaves, ``ffn`` or ``cmoe``
subtrees with the same keys), so crossing over is a leaf-by-leaf copy and
both packages then compute the same function from the same numbers. The
caller hands over host arrays (``jax.device_get(params)``), so this module
never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One host array -> tensor on `device`. bfloat16 arrays (numpy's
    ml_dtypes extension type) cross as their raw 16-bit patterns."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax_numpy(tree, device) -> dict:
    """The JAX package's param pytree as host arrays -> the port's params
    on `device`, same keys and shapes (dense or converted CMoE trees)."""
    if isinstance(tree, dict):
        return {k: params_from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
