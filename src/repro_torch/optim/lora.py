"""LoRA-style low-rank adapters (paper §5.1: rank 8, alpha 32, for the
optional fine-tune after conversion). Port of ``repro/optim/lora.py``.

Functional low-rank deltas: ``init_lora`` builds an adapter tree aligned
with the base params (None where a leaf is not adapted); ``merge_lora``
returns the effective params W + (alpha/r)·A·B. Training differentiates
the loss with respect to the adapter tree only, which composes with the
stacked (L, in, out) weights through a batched product.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_TARGETS = ("wg", "wu", "wd", "wi", "wq", "wk", "wv", "wo",
                   "wg_r", "wu_r", "wi_r")


def init_lora(params, generator: Optional[torch.Generator] = None, *,
              rank: int = 8, targets=DEFAULT_TARGETS):
    """Adapter tree: each targeted leaf (named in ``targets``) of 2-D (in,
    out) shape gets A (in, r) ~ N(0, 1/in) and B (r, out) = 0, of 3-D
    stacked (L, in, out) shape A (L, in, r) and B (L, r, out); every other
    leaf None. A is drawn in float32 from ``generator``, leaf by leaf in
    the params' order (the JAX package draws other numbers)."""
    def make(name, leaf):
        if isinstance(leaf, dict):
            return {k: make(k, v) for k, v in leaf.items()}
        if name not in targets or leaf.dim() not in (2, 3):
            return None
        *lead, din, dout = leaf.shape
        a = torch.randn((*lead, din, rank), generator=generator,
                        dtype=torch.float32, device=leaf.device) * din ** -0.5
        b = torch.zeros((*lead, rank, dout), dtype=torch.float32,
                        device=leaf.device)
        return {"a": a, "b": b}

    return {k: make(k, v) for k, v in params.items()}


def merge_lora(params, lora, *, alpha: float = 32.0, rank: int = 8):
    """Effective params: W + (alpha/rank) · A @ B where adapted, computed in
    float32 and cast back to W's dtype; unadapted leaves are the params'
    own tensors."""
    scale = alpha / rank

    def merge(p, ad):
        if ad is None:
            return p
        if isinstance(p, dict):
            return {k: merge(v, ad[k]) for k, v in p.items()}
        a, b = ad["a"], ad["b"]
        delta = a @ b if p.dim() == 2 else torch.einsum("lir,lro->lio", a, b)
        return (p.float() + scale * delta).to(p.dtype)

    return merge(params, lora)
