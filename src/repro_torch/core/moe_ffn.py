"""The CMoE FFN, the converted layer's runtime (paper Eq. 4):

    F_MoE(x) = E_shared(x) + sum_i g_i * E_i^routed(x)

Port of ``repro/core/moe_ffn.py`` (single device). Routed experts run on
the engine in ``repro_torch.core.experts``. Param schema per layer:
``{"shared": {wg,wu,wd}, "routed": {wg,wu,wd} (N_r, d, m) / (N_r, m, d),
"router": {wg_r,wu_r} (d, N_r), "u": (N_r,), "bias": (N_r,)}`` (or the
{wi,wd} / {wi_r} non-glu variants).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.experts import dropped_pairs, routed_experts
from repro_torch.core.router import cmoe_gate, expert_load, router_scores
from repro_torch.models.layers import gelu, matmul, swish


def _shared_ffn(xf: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        g = matmul(xf, p["wg"]).float()
        u = matmul(xf, p["wu"]).float()
        act = swish if activation == "swiglu" else gelu
        h = (act(g) * u).to(xf.dtype)
    else:
        h = gelu(matmul(xf, p["wi"]).float()).to(xf.dtype)
    return matmul(h, p["wd"])


def cmoe_ffn(x: torch.Tensor, p: dict, cfg, *, use_kernel: bool = False,
             backend: Optional[str] = None, phase: str = "prefill"):
    """x: (B, S, d) or (T, d). Returns (out, aux{load, router_probs_mean,
    dropped}). (Padding masks and per-token k, which the serving engine
    threads through, come with its slice.)"""
    cm = cfg.cmoe
    squeeze = x.dim() == 2
    xf = x if squeeze else x.reshape(-1, x.shape[-1])

    scores = router_scores(xf, p["router"], cfg.activation)
    gates, idx, probs = cmoe_gate(
        scores, cm.top_k,
        u=p.get("u") if cm.learnable_scaling else None,
        bias=p.get("bias"))

    out, keep = routed_experts(xf, p["routed"], gates, idx, cfg,
                               backend=backend, phase=phase,
                               use_kernel=use_kernel)
    out = out + _shared_ffn(xf, p["shared"], cfg.activation)
    aux = {"load": expert_load(idx, keep, cm.num_routed),
           "router_probs_mean": probs.mean(0),
           "dropped": dropped_pairs(keep, None, idx.shape)}
    if not squeeze:
        out = out.reshape(x.shape)
    return out, aux
