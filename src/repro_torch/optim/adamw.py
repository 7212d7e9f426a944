"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule. Port of ``repro/optim/adamw.py``: functions on nested-dict
trees of tensors that return new trees (no ``torch.optim``), with the
reference's rounding points: gradients cast to float32 and then scaled by
the clip, bias corrections from the incremented step, m and v stored in
``moment_dtype``, weight decay only on leaves of two or more dimensions,
and the update in float32 cast back to each parameter's dtype."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.model import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, the number of updates taken
    m: dict
    v: dict


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments shaped as the params, in ``moment_dtype`` (bfloat16
    halves the optimizer's memory; the update math stays float32)."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _decay_mask(params):
    """Weight decay applies to leaves of ndim >= 2 only (not to norm scales
    or biases): 1.0 or 0.0 per leaf, as the reference's float mask."""
    return tree_map(lambda p: float(p.dim() >= 2), params)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to base_lr over ``warmup`` steps, then a cosine decay
    to min_frac * base_lr at ``total``; float32, on step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (new_params, new_state, metrics {grad_norm, lr}). Runs under
    ``torch.no_grad``; every returned leaf is a new tensor."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        if grad_clip > 0:
            scale = torch.where(gnorm > grad_clip,
                                grad_clip / (gnorm + 1e-9),
                                torch.ones_like(gnorm))
        else:
            scale = 1.0
        grads = tree_map(lambda g: g.float() * scale, grads)

        step = state.step + 1
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        b2c = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)
        m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g
                                    ).to(m_.dtype), state.m, grads)
        v = tree_map(lambda v_, g: (b2 * v_.float() + (1 - b2) * g * g
                                    ).to(v_.dtype), state.v, grads)
        mask = _decay_mask(params)

        def upd(p, m_, v_, wd_mask):
            mh = m_.float() / b1c
            vh = v_.float() / b2c
            pf = p.float()
            delta = mh / (torch.sqrt(vh) + eps) + \
                weight_decay * wd_mask * pf
            return (pf - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, m, v, mask)
    return new_params, AdamWState(step, m, v), {"grad_norm": gnorm,
                                                "lr": lr}

