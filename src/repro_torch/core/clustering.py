"""Balanced k-means over neuron activation patterns (paper §A.3). Port of
``repro/core/clustering.py``.

Two balanced-assignment backends:
  * ``jv``       exact Jonker-Volgenant via scipy's ``linear_sum_assignment``
                 on the column-expanded cost, O(n^3): the paper's choice,
                 used for n <= 2048 (qwen1.5-0.5b's 1760 routed neurons);
  * ``sinkhorn`` an entropic-OT relaxation (log-space Sinkhorn in PyTorch)
                 plus greedy capacity rounding: the large-d_h path
                 (llama2-7b's n > 2048).

Clustering runs on the host (CPU tensors and numpy): at these sizes the
distances are a few milliseconds and the assignment is host code anyway.

Both satisfy the hard balance constraint: every cluster gets exactly m
members. L2 on binary activation columns is Hamming distance (Eq. 19).
Distances are float32 like the reference's, but summed in PyTorch's order
rather than XLA's, so where two assignments tie to the last bit the two
packages may split the tie differently.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ClusterResult:
    assignment: np.ndarray      # (n,) int32 cluster id, balanced
    centroids: np.ndarray       # (N_r, q) float32
    inertia: float              # sum of squared distances to centroid
    iters: int


def pairwise_sqdist(feats: torch.Tensor, centroids: torch.Tensor
                    ) -> torch.Tensor:
    """||c_i - c_j||^2 via the expansion trick. feats (n, q), centroids
    (k, q), both float32."""
    f2 = (feats * feats).sum(dim=1, keepdim=True)                # (n, 1)
    c2 = (centroids * centroids).sum(dim=1)[None, :]             # (1, k)
    cross = feats @ centroids.T                                   # (n, k)
    return torch.clamp(f2 - 2.0 * cross + c2, min=0.0)


def _sqdist_np(feats, centroids) -> np.ndarray:
    f = torch.as_tensor(feats, dtype=torch.float32)
    c = torch.as_tensor(centroids, dtype=torch.float32)
    return pairwise_sqdist(f, c).numpy()


# ------------------------------------------------------------- backends

def assign_jv(dist: np.ndarray, m: int) -> np.ndarray:
    """Exact balanced assignment: expand each cluster column into m unit-
    capacity columns and solve the square LAP (Jonker-Volgenant)."""
    from scipy.optimize import linear_sum_assignment
    n, k = dist.shape
    if n != k * m:
        raise ValueError(f"{n} points do not fill {k} clusters of {m}")
    expanded = np.repeat(dist, m, axis=1)                         # (n, n)
    rows, cols = linear_sum_assignment(expanded)
    assignment = np.empty(n, np.int32)
    assignment[rows] = cols // m
    return assignment


def sinkhorn_plan(dist: torch.Tensor, m: int, tau: float, iters: int
                  ) -> torch.Tensor:
    """Entropic OT plan with row marginal 1 and column marginal m
    (log-space Sinkhorn), the PyTorch twin of the reference's JAX loop."""
    n, k = dist.shape
    logk = -dist.float() / tau                                    # (n, k)
    log_c = torch.full((k,), float(np.log(float(m))), device=dist.device)
    f = torch.zeros((n,), device=dist.device)
    g = torch.zeros((k,), device=dist.device)
    for _ in range(iters):
        f = -torch.logsumexp(logk + g[None, :], dim=1)           # row mass 1
        g = log_c - torch.logsumexp(logk + f[:, None], dim=0)
    return torch.exp(logk + f[:, None] + g[None, :])


def round_plan_greedy(plan: np.ndarray, m: int) -> np.ndarray:
    """Round a soft plan to a hard balanced assignment: visit (i, j) cells
    by descending plan mass, assign while capacity remains."""
    n, k = plan.shape
    order = np.argsort(-plan, axis=None)
    assignment = np.full(n, -1, np.int32)
    capacity = np.full(k, m, np.int32)
    assigned = 0
    for flat in order:
        i, j = divmod(int(flat), k)
        if assignment[i] < 0 and capacity[j] > 0:
            assignment[i] = j
            capacity[j] -= 1
            assigned += 1
            if assigned == n:
                break
    if assigned < n:                   # any stragglers take what is left
        rem = np.where(assignment < 0)[0]
        slots = np.repeat(np.arange(k), capacity)
        assignment[rem] = slots[:len(rem)]
    return assignment


def assign_sinkhorn(dist: np.ndarray, m: int, tau: float = 0.05,
                    iters: int = 100) -> np.ndarray:
    scale = float(np.median(dist)) + 1e-9
    plan = sinkhorn_plan(torch.as_tensor(dist / scale), m, tau, iters)
    return round_plan_greedy(plan.numpy(), m)


# ------------------------------------------------------------- k-means

def balanced_kmeans(feats: np.ndarray, num_clusters: int, *,
                    init_order: np.ndarray | None = None,
                    method: str = "auto", max_iters: int = 8,
                    tau: float = 0.05, sinkhorn_iters: int = 100,
                    tol: float = 1e-4) -> ClusterResult:
    """Balanced k-means: every cluster ends with exactly n/num_clusters
    members. feats: (n, q); ``init_order``: priority order for centroid
    seeding; ``method``: jv | sinkhorn | auto (jv when n <= 2048)."""
    feats = np.asarray(feats, np.float32)
    n, _ = feats.shape
    if n % num_clusters:
        raise ValueError(f"{n} points do not split into {num_clusters} "
                         f"equal clusters")
    m = n // num_clusters
    if method == "auto":
        method = "jv" if n <= 2048 else "sinkhorn"
    if init_order is None:
        init_order = np.arange(n)
    centroids = feats[init_order[:num_clusters]].copy()
    feats_t = torch.as_tensor(feats)

    assignment = None
    inertia = np.inf
    it = 0
    for it in range(1, max_iters + 1):
        dist = _sqdist_np(feats_t, centroids)
        if method == "jv":
            new_assignment = assign_jv(dist, m)
        elif method == "sinkhorn":
            new_assignment = assign_sinkhorn(dist, m, tau=tau,
                                             iters=sinkhorn_iters)
        else:
            raise ValueError(method)
        new_inertia = float(dist[np.arange(n), new_assignment].sum())
        for j in range(num_clusters):                 # centroid update (Eq. 21)
            members = feats[new_assignment == j]
            if len(members):
                centroids[j] = members.mean(axis=0)
        if assignment is not None and (assignment == new_assignment).all():
            assignment, inertia = new_assignment, new_inertia
            break
        if new_inertia > inertia - tol * max(inertia, 1.0) and \
                assignment is not None:
            if new_inertia < inertia:
                assignment, inertia = new_assignment, new_inertia
            break
        assignment, inertia = new_assignment, new_inertia
    return ClusterResult(assignment=assignment, centroids=centroids,
                         inertia=inertia, iters=it)


def representative_neurons(feats: np.ndarray, result: ClusterResult
                           ) -> np.ndarray:
    """R_j = argmin over cluster j of ||c_i - c_j|| (Eq. 7/25). Returns
    (N_r,) indices into feats rows."""
    k = result.centroids.shape[0]
    dist = _sqdist_np(np.asarray(feats, np.float32), result.centroids)
    reps = np.empty(k, np.int64)
    for j in range(k):
        members = np.where(result.assignment == j)[0]
        reps[j] = members[np.argmin(dist[members, j])]
    return reps
