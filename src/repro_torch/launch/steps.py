"""The train step. Port of ``repro/launch/steps.py``: the train step
differentiates ``Model.loss`` with autograd and applies ``adamw_update``;
no compilation. The reference's prefill and decode step wrappers serve
only its dry run, which is not ported."""
from __future__ import annotations

import torch

from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.optim.adamw import AdamWState


def value_and_grad(loss_fn, params, *, fill: bool = True):
    """(loss, metrics), grads of ``loss_fn(params)`` with respect to every
    floating-point leaf of params. grads has the params' keys; a leaf the
    loss does not reach (a balance bias, which steers selection only) gets
    zeros, as jax.grad gives it, or None with ``fill=False``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    (loss, metrics) = loss_fn(leaves)
    flat = [x for x in tree_leaves(leaves) if x.requires_grad]
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad_of(x):
        g = next(got) if x.requires_grad else None
        return torch.zeros_like(x) if g is None and fill else g

    return (loss.detach(), metrics), tree_map(grad_of, leaves)


def make_train_step(model, *, lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, weight_decay: float = 0.1,
                    b1: float = 0.9, b2: float = 0.95,
                    grad_clip: float = 1.0, remat: bool = True):
    """train_step(params, opt, batch) -> (params, opt, metrics): the loss
    and its gradients, the learning rate of ``cosine_schedule`` at
    opt.step, then ``adamw_update``. metrics: loss, grad_norm, lr, and
    moe_load (L, E) where the model has routed experts."""
    def train_step(params, opt: AdamWState, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: model.loss(p, batch, remat=remat), params)
        lr_t = cosine_schedule(opt.step, lr, warmup, total)
        params, opt, om = adamw_update(
            grads, opt, params, lr=lr_t, b1=b1, b2=b2,
            weight_decay=weight_decay, grad_clip=grad_clip)
        out_metrics = {"loss": loss, **om}
        if "moe_load" in metrics:
            out_metrics["moe_load"] = metrics["moe_load"].detach()
        return params, opt, out_metrics

    return train_step

