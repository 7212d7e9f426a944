"""Analytical router (paper §4.2) and gating with learnable scaling and the
aux-loss-free load-balance bias (paper §4.3, Eq. 9). Port of
``repro/core/router.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import gelu, matmul, swish


def router_scores(x: torch.Tensor, router_p: dict, activation: str
                  ) -> torch.Tensor:
    """G(x) = Swish(x W_gate^R) * (x W_up^R) (Eq. 8): the FFN's own
    representative-neuron columns. x: (T, d) -> scores (T, N_r) f32."""
    if activation in ("swiglu", "geglu"):
        g = matmul(x, router_p["wg_r"]).float()
        u = matmul(x, router_p["wu_r"]).float()
        act = swish if activation == "swiglu" else gelu
        return act(g) * u
    return gelu(matmul(x, router_p["wi_r"]).float())


def top_k_lower_first(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken toward the LOWER index, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no tie order). A stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cmoe_gate(scores: torch.Tensor, top_k: int, *,
              u: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              k_row: Optional[torch.Tensor] = None):
    """Top-N_k gating (Eq. 9) with per-token effective k.

    scores: (T, N_r) raw router scores. Returns (gates (T,k), idx (T,k)
    int64, probs (T,N_r)). Training-free: u=0 gives gates of exactly 1. The
    balance bias shifts SELECTION only, never the gate value.

    k_row: optional (T,) per-token effective k in [1, top_k]; assignment
    columns j >= k_row[t] are re-aimed at the out-of-range expert N_r (the
    sentinel every backend drops) and their gate is zeroed.
    """
    probs = torch.softmax(scores, dim=-1)
    sel = probs if bias is None else probs + bias[None, :]
    _, idx = top_k_lower_first(sel, top_k)
    p_sel = torch.gather(probs, 1, idx)
    if u is None:
        gates = torch.ones_like(p_sel)
    else:
        gates = 1.0 + p_sel * u[idx]
    if k_row is not None:
        n_r = scores.shape[-1]
        live = (torch.arange(top_k, device=idx.device)[None, :] <
                k_row.to(idx.device)[:, None])                 # (T, k)
        idx = torch.where(live, idx, torch.full_like(idx, n_r))
        gates = gates * live.to(gates.dtype)
    return gates, idx, probs


def expert_load(idx: torch.Tensor, keep: torch.Tensor, num_experts: int
                ) -> torch.Tensor:
    """Utilization fraction per expert from selected indices (T, k). The
    sentinel id ``num_experts`` (invalidated assignments) is dropped."""
    counts = torch.zeros(num_experts + 1, dtype=torch.float32,
                         device=idx.device)
    counts.index_add_(0, idx.reshape(-1).clamp(0, num_experts),
                      keep.reshape(-1).float())
    counts = counts[:num_experts]
    return counts / torch.clamp(counts.sum(), min=1.0)
