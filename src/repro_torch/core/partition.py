"""Neuron partitioning (paper §4.1): shared experts by activation rate,
routed experts by balanced clustering, and assembly of the CMoE parameter
tree from slices of the ORIGINAL FFN weights. Port of
``repro/core/partition.py``.

The conversion is exact by construction: shared and routed neurons form a
permutation of the original hidden dimension, so activating everything
reproduces the dense output.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import CMoEConfig
from repro_torch.core.clustering import (ClusterResult, balanced_kmeans,
                                         representative_neurons)


@dataclass
class PartitionResult:
    shared_idx: np.ndarray        # (N_s * m,) original neuron indices
    routed_idx: np.ndarray        # (N_r, m) original neuron indices
    rep_idx: np.ndarray           # (N_r,) representative neuron (original id)
    mu: np.ndarray                # (d_h,) activation rates
    cluster: ClusterResult | None


def partition_neurons(a: np.ndarray, mu: np.ndarray,
                      cm: CMoEConfig) -> PartitionResult:
    """a: (q, d_h) int8 ATopK matrix, mu: (d_h,) rates (host arrays)."""
    a = np.asarray(a)
    mu = np.asarray(mu)
    dh = mu.shape[0]
    n = cm.num_experts
    if dh % n:
        raise ValueError(f"d_h={dh} not divisible by num_experts={n}")
    m = dh // n
    n_shared = cm.num_shared * m

    order = np.argsort(-mu, kind="stable")
    shared_idx = np.sort(order[:n_shared])
    routed_pool = np.sort(order[n_shared:])                  # original ids

    feats = a[:, routed_pool].T.astype(np.float32)           # (n_routed, q)
    # centroid seeding: highest-rate neurons among the routed pool (Eq. 17)
    seed_order = np.argsort(-mu[routed_pool], kind="stable")
    result = balanced_kmeans(feats, cm.num_routed,
                             init_order=seed_order,
                             method=cm.assignment,
                             tau=cm.sinkhorn_tau,
                             sinkhorn_iters=cm.sinkhorn_iters)
    routed_idx = np.stack([routed_pool[result.assignment == j]
                           for j in range(cm.num_routed)])   # (N_r, m)
    reps_local = representative_neurons(feats, result)
    rep_idx = routed_pool[reps_local]
    return PartitionResult(shared_idx=shared_idx, routed_idx=routed_idx,
                           rep_idx=rep_idx, mu=mu, cluster=result)


def build_cmoe_params(ffn: dict, part: PartitionResult, cm: CMoEConfig,
                      activation: str) -> dict:
    """Slice the original FFN weights into the CMoE parameter tree, on the
    weights' device. ffn: {"wg": (d, d_h), "wu": (d, d_h), "wd": (d_h, d)}
    for glu, {"wi", "wd"} for gelu. Banks come out contiguous, as the
    kernels take them."""
    dev = ffn["wd"].device
    sh = torch.as_tensor(part.shared_idx, device=dev)
    rt = torch.as_tensor(part.routed_idx, device=dev)         # (N_r, m)
    rep = torch.as_tensor(part.rep_idx, device=dev)
    wd = ffn["wd"]

    def bank(w):                                              # (N_r, d, m)
        return w[:, rt].transpose(0, 1).contiguous()

    if activation in ("swiglu", "geglu"):
        wg, wu = ffn["wg"], ffn["wu"]
        shared = {"wg": wg[:, sh], "wu": wu[:, sh], "wd": wd[sh, :]}
        routed = {"wg": bank(wg), "wu": bank(wu), "wd": wd[rt, :]}
        router = {"wg_r": wg[:, rep], "wu_r": wu[:, rep]}     # (d, N_r)
    else:
        wi = ffn["wi"]
        shared = {"wi": wi[:, sh], "wd": wd[sh, :]}
        routed = {"wi": bank(wi), "wd": wd[rt, :]}
        router = {"wi_r": wi[:, rep]}
    zeros = torch.zeros((cm.num_routed,), dtype=torch.float32, device=dev)
    return {"shared": shared, "routed": routed, "router": router,
            "u": zeros, "bias": zeros.clone()}
