"""Pretrained-MoE FFN block (deepseek-v2) on the routed-expert engine.

Port of the single-device paths of ``repro/models/moe.py``: the top-k
softmax router with the aux-loss-free balance bias, the shared experts,
dispatch through ``repro_torch.core.experts.routed_experts``, whose backends
are drop-free, and the capacity-buffer ``expert_ffn`` with the engine's
capacity machinery re-exported, as the reference has them. The sharded
``moe_ffn_local`` (the reference's caller of that machinery, with
``expert_capacity``) is not ported yet (ROADMAP Queue 1, sharded paths).
"""
from __future__ import annotations

from typing import Optional

import torch

# Re-exports, as the reference keeps them importable from here.
from repro_torch.core.experts import (DispatchInfo,  # noqa: F401
                                      assign_positions, combine, dispatch,
                                      dropped_pairs, grouped_expert_ffn,
                                      routed_experts)
from repro_torch.core.router import top_k_lower_first
from repro_torch.models.layers import gelu, lecun, matmul, swish


def expert_ffn(xbuf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, activation: str, use_kernel: bool = False
               ) -> torch.Tensor:
    """Batched expert FFN: (E, C, d) with per-expert weights (E, d, m).
    Thin glu-schema wrapper over the engine's ``grouped_expert_ffn`` (the
    CUDA ``moe_gmm`` under ``use_kernel`` on a CUDA tensor)."""
    return grouped_expert_ffn(xbuf, {"wg": wg, "wu": wu, "wd": wd},
                              activation, use_kernel=use_kernel)


def moe_gate(xf: torch.Tensor, p: dict, moe):
    """Top-k softmax router with the optional balance bias. The bias shifts
    the SELECTION only: gates are the true probabilities of the chosen
    experts, renormalised. Ties go to the lower index, as
    ``jax.lax.top_k`` breaks them. xf: (T, d). Returns (gates (T, k),
    idx (T, k) int64, probs (T, E))."""
    # the router's scores are rounded to x's dtype, then softmaxed in f32
    scores = matmul(xf, p["router"]).float()
    probs = torch.softmax(scores, dim=-1)
    sel = probs
    if moe.balance_bias and "balance_bias" in p:
        sel = probs + p["balance_bias"].float()[None, :]
    _, idx = top_k_lower_first(sel, moe.top_k)
    gates = torch.gather(probs, 1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def moe_ffn(x: torch.Tensor, p: dict, cfg, *, use_kernel: bool = False,
            backend: Optional[str] = None, phase: str = "prefill",
            valid: Optional[torch.Tensor] = None):
    """The pretrained-MoE FFN: routed top-k experts plus the always-active
    shared experts. x: (B, S, d); valid: optional (B*S, 1) bool, False rows
    (padded serving prompts) take no routed work and no load share.
    Returns (out (B, S, d), aux{load, router_probs_mean, dropped}): load is
    each expert's share of the T*k assignments kept."""
    moe = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    t = b * s
    gates, idx, probs = moe_gate(xf, p, moe)
    out, keep = routed_experts(
        xf, {"wg": p["wg"], "wu": p["wu"], "wd": p["wd"]}, gates, idx, cfg,
        backend=backend, phase=phase, use_kernel=use_kernel, valid=valid)
    if moe.num_shared > 0:
        g = matmul(xf, p["shared_wg"]).float()
        u = matmul(xf, p["shared_wu"]).float()
        act = swish if cfg.activation == "swiglu" else gelu
        h = (act(g) * u).to(x.dtype)
        out = out + matmul(h, p["shared_wd"])
    load = torch.zeros(moe.num_experts, dtype=torch.float32,
                       device=x.device)
    load.index_add_(0, idx.reshape(-1), keep.reshape(-1).float())
    aux = {"load": load / (t * moe.top_k),
           "router_probs_mean": probs.mean(0),
           "dropped": dropped_pairs(keep, valid, idx.shape)}
    return out.reshape(b, s, d), aux


def init_moe_ffn(cfg, dtype, device, generator) -> dict:
    """Random pretrained-MoE parameters in the JAX layout: router (d, E),
    expert banks (E, d, m) / (E, m, d), a zero f32 balance bias, and the
    shared experts as one (d, d_shared) FFN."""
    moe = cfg.moe
    d, e, m = cfg.d_model, moe.num_experts, moe.d_expert

    def w(shape, fan_in):
        return lecun(shape, dtype, device, generator, fan_in)

    p = {"router": w((d, e), d),
         "wg": w((e, d, m), d),
         "wu": w((e, d, m), d),
         "wd": w((e, m, d), m),
         "balance_bias": torch.zeros((e,), dtype=torch.float32,
                                     device=device)}
    if moe.num_shared > 0:
        p["shared_wg"] = w((d, moe.d_shared), d)
        p["shared_wu"] = w((d, moe.d_shared), d)
        p["shared_wd"] = w((moe.d_shared, d), moe.d_shared)
    return p
