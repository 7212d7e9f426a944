"""Routed-expert execution engine. Port of ``repro/core/experts.py``.

Backends (``routed_experts(..., backend=...)``); the JAX package's names in
brackets:

  backend          dispatch             compute                    use
  ---------------  -------------------  -------------------------  --------
  exact            none (dense mask)    all E experts, (T, E, d)   oracle
  grouped_plain    ragged segment sort  per-row-tile GEMMs against  prefill
  [grouped_xla]    (stable by expert)   the tile owner's slab,
                                        in PyTorch
  grouped_kernel   ragged segment sort  the CUDA ``moe_gmm_ragged``  prefill
  [grouped_pallas]                      kernel (plain version on     (CUDA)
                                        a CPU tensor)
  gather           per-token expert     (T*k,) rows, only selected  decode
                   ids, no buffer       experts; with use_kernel
                                        the CUDA ``moe_gather``

The per-token capacity contract holds on every backend: no (token, expert)
assignment is ever dropped, and a token's routed output does not depend on
which other tokens share its micro-batch. The grouped backends sort the T*k
assignments by expert into a block-aligned ragged layout (every row tile
belongs to one expert) whose row tile is a process constant, so each row is
an independent product against its expert's weights.

``select_backend`` uses the ~E/k break-even heuristic only. The JAX
package's measured-crossover file holds CPU numbers at another bank shape
and is not read here.

The bounded-buffer machinery (``assign_positions`` / ``dispatch`` /
``combine`` over dense (E, C, d) capacity buffers, and
``grouped_expert_ffn``, whose kernel is the CUDA ``moe_gmm``) is ported as
the reference has it, with no caller on a model path: the reference's
callers are ``models.moe.expert_ffn`` and the sharded EP binning (not
ported). Every function takes the capacity as an argument.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import gelu, swish

BACKENDS = ("exact", "grouped_plain", "grouped_kernel", "gather")

# Break-even floor: below this many tokens gather beats the segment sort
# even for prefill-shaped calls (with a known bank the threshold is ~E/k).
GATHER_TOKEN_THRESHOLD = 8

# Row tile of the plain segment-GEMM layout: a fixed constant, never derived
# from T (part of the width-invariance contract), small so per-expert
# padding stays bounded at serving-chunk widths.
RAGGED_BLOCK_PLAIN = 8

# Row tiles per GEMM call on the plain segment path: bounds the gathered
# weight slabs resident at once, and keeps every call the same shape (the
# last chunk is padded), so a row's value cannot depend on the layout width.
SEGMENT_STREAM_TILES = 8


def _act(activation: str):
    return swish if activation == "swiglu" else gelu


def _is_glu(weights: dict) -> bool:
    return "wg" in weights


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dropped_pairs(keep: torch.Tensor, valid: Optional[torch.Tensor], shape
                  ) -> torch.Tensor:
    """Real (token, expert) assignments a dispatch failed to keep: zero on
    every engine backend, the surfacing seam for bounded-buffer stages."""
    vmask = torch.ones(shape, dtype=torch.bool, device=keep.device) \
        if valid is None else torch.broadcast_to(valid, shape)
    return (vmask & ~keep).sum().to(torch.int32)


# ------------------------------------------------------- capacity dispatch

class DispatchInfo(NamedTuple):
    expert_idx: torch.Tensor    # (T, k) expert ids (E = sentinel)
    position: torch.Tensor      # (T, k) int64 position in its expert buffer
    keep: torch.Tensor          # (T, k) bool: False if over capacity
    gates: torch.Tensor         # (T, k) combine weights


def assign_positions(expert_idx: torch.Tensor, num_experts: int,
                     capacity: int, priority: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-assignment position within its expert's bounded buffer: the
    assignment's rank among all assignments aimed at the same expert,
    ordered by DESCENDING ``priority`` (router weight), ties to the lower
    flat assignment id (token-major); with ``priority=None`` by flat id
    alone. Rank >= capacity is dropped, so overflow evicts the
    lowest-weighted assignments first.

    The reference's lexsort on (flat id, -priority, expert) becomes stable
    sorts, least significant key first: the flat ids are already in order,
    so a stable sort by -priority, then a stable sort by expert. The
    sentinel id ``num_experts`` ranks in its own phantom segment and takes
    no real expert's capacity.

    expert_idx: (T, k). Returns (position (T, k) int64, keep (T, k))."""
    t, k = expert_idx.shape
    n = t * k
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()
    if priority is None:
        order = torch.arange(n, device=dev)
    else:
        order = torch.argsort(-priority.reshape(-1).float(), stable=True)
    order = order[torch.argsort(flat_e[order], stable=True)]
    sorted_e = flat_e[order]
    counts = torch.zeros(num_experts + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(n, device=dev) - starts[sorted_e]
    position = torch.empty_like(rank)
    position[order] = rank
    position = position.reshape(t, k)
    return position, position < capacity


def dispatch(x: torch.Tensor, info: DispatchInfo, num_experts: int,
             capacity: int) -> torch.Tensor:
    """x: (T, d) -> expert buffers (E, C, d). Dropped assignments add an
    exact zero; the sentinel expert's writes land in one spare expert
    block that is cut off (the reference's ``mode="drop"``)."""
    t, d = x.shape
    k = info.expert_idx.shape[1]
    flat_e = info.expert_idx.reshape(-1).long().clamp(0, num_experts)
    keep = info.keep.reshape(-1)
    flat_p = torch.where(keep, info.position.reshape(-1).long(), 0)
    contrib = x.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((num_experts + 1, capacity, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((flat_e, flat_p), contrib, accumulate=True)
    return buf[:num_experts]


def combine(ybuf: torch.Tensor, info: DispatchInfo) -> torch.Tensor:
    """ybuf: (E, C, d) -> (T, d), each assignment's row weighted by gate x
    keep. The reference's gather ``ybuf[flat_e, flat_p]`` CLAMPS an
    out-of-range index (JAX gather semantics: the sentinel id reads expert
    E - 1); torch indexing would raise, so the clamp is explicit."""
    t, k = info.expert_idx.shape
    n_e, c = ybuf.shape[:2]
    keep = info.keep.reshape(-1)
    flat_e = info.expert_idx.reshape(-1).long().clamp(0, n_e - 1)
    flat_p = torch.where(keep, info.position.reshape(-1).long(),
                         0).clamp(0, c - 1)
    rows = ybuf[flat_e, flat_p]                              # (T*k, d)
    w = info.gates.reshape(-1, 1).to(ybuf.dtype) * \
        keep.reshape(-1, 1).to(ybuf.dtype)
    return (rows * w).reshape(t, k, -1).sum(dim=1)


# ------------------------------------------------- ragged segment dispatch

def ragged_layout(flat_e: torch.Tensor, num_experts: int, block: int):
    """Sort N flat assignments by expert id into a block-aligned ragged
    layout: each expert's segment starts on a ``block`` row boundary, so
    every (block, d) row tile belongs to exactly one expert. Only the
    worst-case extent P = round_up(N + E*(block-1), block) is a shape.
    Assignments with the sentinel id ``num_experts`` get slot P (no row).

    Returns (slot (N,) int64, owner (P/block,) int32 expert per tile,
    group_sizes (E,) block-rounded segment sizes, P)."""
    n = flat_e.shape[0]
    dev = flat_e.device
    p_total = round_up(n + num_experts * (block - 1), block)
    nb = p_total // block
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # a scatter-add rather than bincount, which reads the max id back to
    # the host (a device sync that would stall the overlapped engine)
    counts = torch.zeros(num_experts + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))      # [E] masked
    padded = ((counts[:num_experts] + block - 1) // block) * block
    zero = torch.zeros(1, dtype=counts.dtype, device=dev)
    poff = torch.cat([zero, torch.cumsum(padded, 0)])             # (E + 1,)
    starts = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])      # (E + 1,)
    rank = torch.arange(n, device=dev) - starts[sorted_e]
    slot_sorted = torch.where(
        sorted_e < num_experts,
        poff[sorted_e.clamp(max=num_experts - 1)] + rank,
        torch.full_like(rank, p_total))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    tile_start = torch.arange(nb, device=dev) * block
    owner = torch.searchsorted(poff[1:].contiguous(), tile_start, right=True)
    owner = owner.clamp(max=num_experts - 1).to(torch.int32)
    return slot, owner, padded.to(torch.int32), p_total


def ragged_scatter(xf: torch.Tensor, top_k: int, slot: torch.Tensor,
                   p_total: int) -> torch.Tensor:
    """Each assignment's token row into its layout row; sentinel slots (P)
    land in a spare row that is cut off (no boolean mask, so no device
    sync)."""
    n = slot.shape[0]
    tok = torch.arange(n, device=xf.device) // top_k
    xp = torch.zeros((p_total + 1, xf.shape[1]), dtype=xf.dtype,
                     device=xf.device)
    xp[slot] = xf[tok]
    return xp[:p_total]


def ragged_combine(yp: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                   vmask: Optional[torch.Tensor], t: int, top_k: int
                   ) -> torch.Tensor:
    """Gather each assignment's expert output back and gate-weight the k
    contributions per token. Sentinel assignments read a clamped (zero)
    row and carry a zeroed gate."""
    p_total = yp.shape[0]
    rows = yp[slot.clamp(max=p_total - 1)]
    w = gates.to(yp.dtype)
    if vmask is not None:
        w = w * vmask.to(yp.dtype)
    return (rows.reshape(t, top_k, -1) * w[..., None]).sum(dim=1)


def segment_dot(xp: torch.Tensor, owner: torch.Tensor, bank: torch.Tensor,
                block: int) -> torch.Tensor:
    """One segment GEMM over a ragged layout: xp (P, a) expert-sorted rows
    against an (E, a, b) bank -> (P, b) float32. One (block, a) x (a, b)
    product per row tile against its owner's slab, SEGMENT_STREAM_TILES
    tiles per call (the last call padded), so every call has one shape."""
    p_total, a = xp.shape
    nb = p_total // block
    xb = xp.reshape(nb, block, a).float()
    pad = (-nb) % SEGMENT_STREAM_TILES
    if pad:
        xb = torch.cat([xb, xb.new_zeros((pad, block, a))])
        owner = torch.cat([owner, owner.new_zeros(pad)])
    own = owner.long()
    outs = []
    for c0 in range(0, nb + pad, SEGMENT_STREAM_TILES):
        sl = slice(c0, c0 + SEGMENT_STREAM_TILES)
        outs.append(torch.bmm(xb[sl], bank[own[sl]].float()))
    return torch.cat(outs)[:nb].reshape(p_total, bank.shape[2])


def segment_ffn_plain(xp: torch.Tensor, owner: torch.Tensor, weights: dict,
                      activation: str, block: int) -> torch.Tensor:
    """Expert FFN over a ragged layout, glu or non-glu, in xp's dtype."""
    act = _act(activation)
    if _is_glu(weights):
        g = segment_dot(xp, owner, weights["wg"], block)
        u = segment_dot(xp, owner, weights["wu"], block)
        h = (act(g) * u).to(xp.dtype)
    else:
        h = act(segment_dot(xp, owner, weights["wi"], block)).to(xp.dtype)
    return segment_dot(h, owner, weights["wd"], block).to(xp.dtype)


# ----------------------------------------------------------- expert GEMMs

def grouped_expert_ffn(xbuf: torch.Tensor, weights: dict, activation: str,
                       use_kernel: bool = False) -> torch.Tensor:
    """Batched expert FFN over DENSE capacity buffers: xbuf (E, C, d) with
    per-expert weights (E, d, m) / (E, m, d) -> (E, C, d) in xbuf's dtype.
    Glu banks under ``use_kernel`` go through ``ops.moe_gmm`` (the CUDA
    kernel on a CUDA tensor); a non-glu {wi, wd} bank runs the plain
    products even then, as the reference does (the kernel is glu-only)."""
    glu = _is_glu(weights)
    if use_kernel and glu:
        from repro_torch.kernels import ops as kops
        return kops.moe_gmm(xbuf, weights["wg"], weights["wu"],
                            weights["wd"], activation=activation)
    act = _act(activation)
    x = xbuf.float()
    if glu:
        g = torch.bmm(x, weights["wg"].to(xbuf.dtype).float())
        u = torch.bmm(x, weights["wu"].to(xbuf.dtype).float())
        h = (act(g) * u).to(xbuf.dtype)
    else:
        g = torch.bmm(x, weights["wi"].to(xbuf.dtype).float())
        h = act(g).to(xbuf.dtype)
    return torch.bmm(h.float(), weights["wd"].to(xbuf.dtype).float()
                     ).to(xbuf.dtype)


def all_experts_ffn(xf: torch.Tensor, weights: dict, activation: str
                    ) -> torch.Tensor:
    """(T, E, d): every expert's output for every token (the oracle)."""
    act = _act(activation)
    x = xf.float()
    if _is_glu(weights):
        g = torch.einsum("td,ndm->tnm", x, weights["wg"].to(xf.dtype).float())
        u = torch.einsum("td,ndm->tnm", x, weights["wu"].to(xf.dtype).float())
        h = (act(g) * u).to(xf.dtype)
    else:
        g = torch.einsum("td,ndm->tnm", x, weights["wi"].to(xf.dtype).float())
        h = act(g).to(xf.dtype)
    return torch.einsum("tnm,nmd->tnd", h.float(),
                        weights["wd"].to(xf.dtype).float()).to(xf.dtype)


# --------------------------------------------------------------- backends

def _exact(xf, weights, gates, idx, activation, valid):
    t = xf.shape[0]
    n_e = weights["wd"].shape[0]
    y_all = all_experts_ffn(xf, weights, activation)           # (T, E, d)
    w = gates.to(y_all.dtype)
    if valid is not None:
        w = w * valid.to(y_all.dtype)
    # one spare column takes the sentinel id, then is dropped
    gmask = torch.zeros((t, n_e + 1), dtype=y_all.dtype, device=xf.device)
    rows = torch.arange(t, device=xf.device)[:, None].expand_as(idx)
    gmask.index_put_((rows, idx.clamp(0, n_e)), w, accumulate=True)
    return torch.einsum("tnd,tn->td", y_all, gmask[:, :n_e])


def _gather(xf, weights, gates, idx, activation, valid, *,
            use_kernel: bool = False):
    """Compute ONLY the selected experts: T*k independent rows. Glu banks
    go through ``moe_gather`` (the CUDA kernel with ``use_kernel``, else
    its plain version), which gives the sentinel id an exact zero row. A
    non-glu bank (the kernels are glu-only) runs ``grouped_plain``, so a
    row gets the bits it gets there: the overlapped engine's fused steps
    run grouped where the sequential steps gather."""
    if not _is_glu(weights):
        return _grouped(xf, weights, gates, idx, activation, valid,
                        use_kernel=False)[0]
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.moe_gather import moe_gather_plain
    t, k = idx.shape
    fn = kops.moe_gather if use_kernel else moe_gather_plain
    y = fn(xf, idx.reshape(-1), *(weights[n].to(xf.dtype)
                                  for n in ("wg", "wu", "wd")),
           top_k=k, activation=activation)
    w = gates.to(xf.dtype)
    if valid is not None:
        w = w * valid.to(xf.dtype)
    return (y.reshape(t, k, -1) * w[..., None]).sum(dim=1)


def _grouped(xf, weights, gates, idx, activation, valid, *, use_kernel):
    """Ragged segment dispatch: sort the T*k assignments by expert into a
    block-aligned layout, run the segment FFN (the ``moe_gmm_ragged``
    kernel, or the plain per-tile GEMMs), combine by the inverse
    permutation. No capacity buffer exists, so nothing can overflow."""
    t, k = idx.shape
    n_e = weights["wd"].shape[0]
    flat_e = idx.reshape(-1)
    vmask = None
    if valid is not None:
        vmask = torch.broadcast_to(valid, idx.shape)
        # masked assignments take the sentinel id BEFORE the sort
        flat_e = torch.where(vmask.reshape(-1), flat_e,
                             torch.full_like(flat_e, n_e))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        block = kops.ragged_block_c()
    else:
        block = RAGGED_BLOCK_PLAIN
    slot, owner, _, p_total = ragged_layout(flat_e, n_e, block)
    xp = ragged_scatter(xf, k, slot, p_total)
    if use_kernel:
        yp = kops.moe_gmm_ragged(xp, owner, weights["wg"], weights["wu"],
                                 weights["wd"], activation=activation,
                                 block_c=block)
    else:
        yp = segment_ffn_plain(xp, owner, weights, activation, block)
    out = ragged_combine(yp, slot, gates, vmask, t, k)
    keep = torch.ones_like(idx, dtype=torch.bool) if vmask is None \
        else vmask
    return out, keep


# ----------------------------------------------------------------- engine

def select_backend(t: int, cfg, phase: str, *, use_kernel: bool = False,
                   num_experts: Optional[int] = None,
                   top_k: Optional[int] = None,
                   effective_k: Optional[float] = None) -> str:
    """Decode -> ``gather``; prefill up to the break-even -> ``gather``;
    larger prefill -> grouped (the kernel when ``use_kernel``).

    The break-even is weight traffic: gather reads t*k expert slabs,
    grouped reads each expert's slab once, so gather wins roughly while
    t*k <= E; the threshold is max(8, E / k). Bank shape comes from
    num_experts/top_k when the caller knows it, else from cfg.cmoe or cfg.moe.

    Phase "mixed" is the overlapped engine's fused step (decode rows and
    flattened chunk rows in one (R, 1) dispatch): it skips decode's
    unconditional gather and thresholds the true fused width.
    ``effective_k`` (a micro-batch's mean per-row k under activation
    tiers) replaces top_k in the break-even."""
    if num_experts is None or top_k is None:
        cm, moe = getattr(cfg, "cmoe", None), getattr(cfg, "moe", None)
        if cm is not None:
            num_experts = num_experts or cm.num_routed
            top_k = top_k or cm.top_k
        elif moe is not None:
            num_experts = num_experts or moe.num_experts
            top_k = top_k or moe.top_k
    threshold = GATHER_TOKEN_THRESHOLD
    if num_experts and top_k:
        k_eff = max(float(effective_k), 1.0) if effective_k else \
            float(top_k)
        threshold = max(threshold, int(num_experts / k_eff))
    if phase == "decode" or t <= threshold:
        return "gather"
    return "grouped_kernel" if use_kernel else "grouped_plain"


def microbatch_backend(cfg, num_tokens: int, phase: str, *,
                       use_kernel: bool = False,
                       override: Optional[str] = None,
                       effective_k: Optional[float] = None
                       ) -> Optional[str]:
    """The backend ``routed_experts`` will run for a (phase, num_tokens)
    micro-batch of this model: None without routed experts, the override
    when one is pinned, else the auto choice (grouped_kernel falls back to
    grouped_plain for non-glu banks, which the kernel does not take).

    For a hierarchical model (cfg.moe and cfg.cmoe both set) the call the
    choice is for is the inner sub-expert pass of
    ``core.hierarchical.hierarchical_moe_ffn``: it runs on the outer ragged
    layout's P rows against the flattened E*N_r' sub-expert bank, so the
    choice is made on those extents, not on the token count."""
    cm = getattr(cfg, "cmoe", None)
    moe = getattr(cfg, "moe", None)
    if cm is None and moe is None:
        return None
    if override not in (None, "auto"):
        return override
    if cm is not None and moe is not None:
        e = moe.num_experts
        p_total = round_up(num_tokens * moe.top_k +
                           e * (RAGGED_BLOCK_PLAIN - 1), RAGGED_BLOCK_PLAIN)
        be = select_backend(p_total, cfg, phase, use_kernel=use_kernel,
                            num_experts=e * cm.num_routed, top_k=cm.top_k,
                            effective_k=effective_k)
    else:
        be = select_backend(num_tokens, cfg, phase, use_kernel=use_kernel,
                            effective_k=effective_k)
    if be == "grouped_kernel" and cfg.activation not in ("swiglu", "geglu"):
        be = "grouped_plain"
    return be


def routed_experts(xf: torch.Tensor, weights: dict, gates: torch.Tensor,
                   idx: torch.Tensor, cfg, *, backend: Optional[str] = None,
                   phase: str = "prefill", use_kernel: bool = False,
                   valid: Optional[torch.Tensor] = None):
    """Run the routed experts selected by (gates, idx) on tokens xf.

    xf: (T, d); weights: {"wg","wu","wd"} (glu) or {"wi","wd"} stacks with
    leading dim E; gates: (T, k); idx: (T, k) expert ids (E = sentinel);
    backend: one of BACKENDS or None/"auto"; valid: optional (T, k) or
    (T, 1) bool, False contributes nothing. Returns (out (T, d), keep
    (T, k) bool) where keep is the valid mask: no backend drops."""
    if backend in (None, "auto"):
        backend = select_backend(xf.shape[0], cfg, phase,
                                 use_kernel=use_kernel,
                                 num_experts=weights["wd"].shape[0],
                                 top_k=idx.shape[1])
        if backend == "grouped_kernel" and not _is_glu(weights):
            backend = "grouped_plain"    # the kernel is glu-only
    elif backend == "grouped_kernel" and not _is_glu(weights):
        raise ValueError("backend='grouped_kernel' requires a glu weight "
                         "schema ({wg,wu,wd}); use 'grouped_plain'")
    activation = cfg.activation
    if backend == "exact":
        out = _exact(xf, weights, gates, idx, activation, valid)
    elif backend == "gather":
        out = _gather(xf, weights, gates, idx, activation, valid,
                      use_kernel=use_kernel)
    elif backend in ("grouped_plain", "grouped_kernel"):
        return _grouped(xf, weights, gates, idx, activation, valid,
                        use_kernel=backend == "grouped_kernel")
    else:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    keep = torch.ones_like(idx, dtype=torch.bool) if valid is None \
        else torch.broadcast_to(valid, idx.shape)
    return out, keep
