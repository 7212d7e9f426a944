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
"""
from __future__ import annotations

from typing import Optional

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
    counts = torch.bincount(flat_e, minlength=num_experts + 1)  # [E] masked
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
    are dropped."""
    n = slot.shape[0]
    tok = torch.arange(n, device=xf.device) // top_k
    live = slot < p_total
    xp = torch.zeros((p_total, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    xp[slot[live]] = xf[tok[live]]
    return xp


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
    its plain version), which gives the sentinel id an exact zero row; the
    non-glu plain path gathers each row's weight slabs here. The
    gate-weighted combine is shared."""
    t, k = idx.shape
    d = xf.shape[1]
    flat = idx.reshape(-1)
    if _is_glu(weights):
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.moe_gather import moe_gather_plain
        fn = kops.moe_gather if use_kernel else moe_gather_plain
        y = fn(xf, flat, *(weights[n].to(xf.dtype) for n in ("wg", "wu",
                                                               "wd")),
               top_k=k, activation=activation)
    else:
        # the sentinel id E is clamped onto a live slab; its zeroed gate
        # erases the contribution exactly
        n_e = weights["wd"].shape[0]
        flat_c = flat.clamp(max=n_e - 1)
        xr = xf.repeat_interleave(k, dim=0).float().unsqueeze(1)  # (n,1,d)
        g = torch.bmm(xr, weights["wi"][flat_c].to(xf.dtype).float())
        h = _act(activation)(g).to(xf.dtype)
        wd = weights["wd"][flat_c].to(xf.dtype).float()
        y = torch.bmm(h.float(), wd).squeeze(1).to(xf.dtype)
    w = gates.to(xf.dtype)
    if valid is not None:
        w = w * valid.to(xf.dtype)
    return (y.reshape(t, k, d) * w[..., None]).sum(dim=1)


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
                   top_k: Optional[int] = None) -> str:
    """Decode -> ``gather``; prefill up to the break-even -> ``gather``;
    larger prefill -> grouped (the kernel when ``use_kernel``).

    The break-even is weight traffic: gather reads t*k expert slabs,
    grouped reads each expert's slab once, so gather wins roughly while
    t*k <= E; the threshold is max(8, E / k). Bank shape comes from
    num_experts/top_k when the caller knows it, else from cfg.cmoe."""
    if num_experts is None or top_k is None:
        spec = getattr(cfg, "cmoe", None)
        if spec is not None:
            num_experts = num_experts or spec.num_routed
            top_k = top_k or spec.top_k
    threshold = GATHER_TOKEN_THRESHOLD
    if num_experts and top_k:
        threshold = max(threshold, int(num_experts / top_k))
    if phase == "decode" or t <= threshold:
        return "gather"
    return "grouped_kernel" if use_kernel else "grouped_plain"


def microbatch_backend(cfg, num_tokens: int, phase: str, *,
                       use_kernel: bool = False,
                       override: Optional[str] = None) -> Optional[str]:
    """The backend ``routed_experts`` will run for a (phase, num_tokens)
    micro-batch of this model: None without routed experts, the override
    when one is pinned, else the auto choice (grouped_kernel falls back to
    grouped_plain for non-glu banks, which the kernel does not take)."""
    if getattr(cfg, "cmoe", None) is None:
        return None
    if getattr(cfg, "moe", None) is not None:
        raise NotImplementedError("hierarchical (MoE + CMoE) models are not "
                                  "ported yet")
    if override not in (None, "auto"):
        return override
    be = select_backend(num_tokens, cfg, phase, use_kernel=use_kernel)
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
