"""Activation profiling (paper §3/§A.2): the ATopK binary activation
matrix and per-neuron activation rates over a calibration set. Port of
``repro/core/profiling.py``; runs on the tensors' device."""
from __future__ import annotations

import torch

from repro_torch.core.router import top_k_lower_first


def atopk_mask(h: torch.Tensor, k_activation: int) -> torch.Tensor:
    """ATopK (Eq. 14): mark the top-K_a neurons by |h| per token, ties to
    the lower neuron index (as jax.lax.top_k). h: (q, d_h) -> (q, d_h)
    int8 with exactly K_a ones per row."""
    q, dh = h.shape
    k = min(k_activation, dh)
    _, idx = top_k_lower_first(h.float().abs(), k)                # (q, k)
    a = torch.zeros((q, dh), dtype=torch.int8, device=h.device)
    return a.scatter_(1, idx, 1)


def activation_rates(a: torch.Tensor) -> torch.Tensor:
    """mu_i = mean over tokens of A[:, i] (Eq. 15), as the count times
    1/q: the rounding of the reference's mean, bit for bit."""
    return a.float().sum(dim=0) * (1.0 / a.shape[0])


def profile_hidden(h: torch.Tensor, k_activation: int):
    """Full profiling: (A (q, d_h) int8, mu (d_h,) f32)."""
    a = atopk_mask(h, k_activation)
    return a, activation_rates(a)
