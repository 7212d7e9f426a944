"""Neuron partitioning (paper §4.1): shared experts by activation rate,
routed experts by balanced clustering, and assembly of the CMoE parameter
tree from slices of the ORIGINAL FFN weights. Port of
``repro/core/partition.py``.

The conversion is exact by construction: shared and routed neurons form a
permutation of the original hidden dimension, so activating everything
reproduces the dense output.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
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


def partition_profiles(profiles: list, cm: CMoEConfig) -> list:
    """``partition_neurons`` of every (a, mu) host profile (one per layer,
    or per expert of a MoE layer), on a thread per core (the LAP solver
    releases the GIL). Each partition is a function of its own profile
    only, so the result is the serial loop's."""
    workers = min(len(profiles), len(os.sched_getaffinity(0)))
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        return list(pool.map(lambda am: partition_neurons(*am, cm),
                             profiles))


def converted_views(bank: torch.Tensor, ms: int, n_r: int, down: bool):
    """The converted (L, E, d, ms) shared and (L, E, N_r', d, m') routed
    banks (for ``down`` (L, E, ms, d) / (L, E, N_r', m', d)) laid over the
    storage of the original (L, E, d, m) / (L, E, m, d) bank: layer l's
    converted pair fills exactly layer l's original region (ms + N_r' m' =
    m), shared first, so each layer's slice of either view is contiguous."""
    lyr, e = bank.shape[:2]
    d = bank.shape[3] if down else bank.shape[2]
    m = bank.shape[2] if down else bank.shape[3]
    mr = (m - ms) // n_r
    per_layer = e * d * m
    off = bank.storage_offset()
    if down:
        shared = bank.as_strided((lyr, e, ms, d), (per_layer, ms * d, d, 1),
                                 off)
        routed = bank.as_strided((lyr, e, n_r, mr, d),
                                 (per_layer, n_r * mr * d, mr * d, d, 1),
                                 off + e * ms * d)
    else:
        shared = bank.as_strided((lyr, e, d, ms), (per_layer, d * ms, ms, 1),
                                 off)
        routed = bank.as_strided((lyr, e, n_r, d, mr),
                                 (per_layer, n_r * d * mr, d * mr, mr, 1),
                                 off + e * d * ms)
    return shared, routed
