"""Hierarchical application to existing MoE models (paper §4.4, Eq. 10).
Port of ``repro/core/hierarchical.py``.

Each routed expert E_i is restructured into shared + routed SUB-experts
with its own analytical sub-router. At runtime the two-level routing is
flattened: the top-level dispatch sorts the T*k (token, expert)
assignments into the engine's block-aligned ragged layout, the per-expert
shared sub-experts and sub-routers run as segment GEMMs over the sorted
rows, and sub-expert selection is a second engine dispatch over the E*N_r'
flat sub-experts. No outer pair is ever dropped and a token's output does
not depend on its micro-batch, so all-active conversion is exact.

Param layout on a converted MoE block:
  p["moe"]   keeps router / balance_bias / shared_* (top level, unchanged)
  p["cmoe"]  = {
     "shared": {wg,wu,wd}: (E, d, ms) / (E, ms, d),
     "routed": {wg,wu,wd}: (E, N_r', d, m') / (E, N_r', m', d),
     "router": {wg_r,wu_r}: (E, d, N_r'),
     "u", "bias": (E, N_r'),
  }
(each leaf stacked over the MoE layers as (L, ...); an interleaved stack,
llama4's, converts its ``blocks_moe`` and keeps its dense layers dense).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.config import CMoEConfig
from repro_torch.core.experts import (RAGGED_BLOCK_PLAIN, dropped_pairs,
                                      ragged_combine, ragged_layout,
                                      ragged_scatter, routed_experts,
                                      segment_dot)
from repro_torch.core.partition import (build_cmoe_params, converted_views,
                                        partition_neurons, partition_profiles)
from repro_torch.core.profiling import profile_hidden
from repro_torch.core.router import top_k_lower_first
from repro_torch.models.layers import ffn_hidden, gelu, matmul, swish
from repro_torch.models.model import Model, build_model, tree_stack
from repro_torch.models.moe import moe_gate

BANKS = ("wg", "wu", "wd")


@dataclass
class HierarchicalReport:
    seconds_total: float
    num_layers: int
    num_experts: int
    seconds_profile: float = 0.0    # calibration taps + each expert's ATopK
    seconds_cluster: float = 0.0    # the host partitions


def profile_expert(ffn_e: dict, x_calib, cm: CMoEConfig, activation: str):
    """One expert's ATopK profile on its weights' device, as host arrays
    (a (q, m) int8, mu (m,) f32)."""
    a, mu = profile_hidden(ffn_hidden(x_calib, ffn_e, activation),
                           cm.k_activation)
    return a.cpu().numpy(), mu.cpu().numpy()


def convert_expert(wg_e, wu_e, wd_e, x_calib, cm: CMoEConfig,
                   activation: str):
    """Convert ONE routed expert (d, m) weights into sub-experts."""
    ffn_e = {"wg": wg_e, "wu": wu_e, "wd": wd_e}
    part = partition_neurons(*profile_expert(ffn_e, x_calib, cm, activation),
                             cm)
    return build_cmoe_params(ffn_e, part, cm, activation), part


def convert_moe_model(model: Model, params: dict, calib_batch: dict,
                      cm: CMoEConfig):
    """Hierarchically convert every routed expert of every MoE layer.
    Returns (converted model, converted params, HierarchicalReport).

    The converted banks take over the storage of the original ones, layer
    by layer: the originals of layer l are copied out (one layer's banks),
    converted, and written back over their own region, so the peak is the
    model plus one layer's banks. ``params`` gives up its expert banks:
    they are removed from its ``blocks["moe"]`` (``blocks_moe["moe"]`` for
    an interleaved stack, whose MoE layers are the ones converted)."""
    cfg = model.cfg
    assert cfg.family == "moe", cfg.family
    t0 = time.perf_counter()
    taps = model.ffn_inputs(params, calib_batch)            # (L, B, S, d)
    interleaved = isinstance(taps, dict)
    if interleaved:
        taps = taps["moe"]
    lyr, b, s, d = taps.shape
    x_all = taps.reshape(lyr, b * s, d)

    key = "blocks_moe" if interleaved else "blocks"
    blocks = params[key]
    moe = blocks["moe"]
    banks = {n: moe.pop(n).contiguous() for n in BANKS}
    e, _, m = banks["wg"].shape[1:]
    ms = cm.num_shared * (m // cm.num_experts)
    views = {n: converted_views(banks[n], ms, cm.num_routed, n == "wd")
             for n in BANKS}
    small = []                                   # router, u, bias per layer
    t_profile = time.perf_counter() - t0
    t_cluster = 0.0
    for li in range(lyr):
        t1 = time.perf_counter()
        orig = {n: banks[n][li].clone() for n in BANKS}   # (E, d, m) ...
        profiles = [profile_expert({n: orig[n][ei] for n in BANKS},
                                   x_all[li], cm, cfg.activation)
                    for ei in range(e)]
        t2 = time.perf_counter()
        parts = partition_profiles(profiles, cm)
        t3 = time.perf_counter()
        t_profile += t2 - t1
        t_cluster += t3 - t2
        per_expert = []
        for ei, part in enumerate(parts):
            conv = build_cmoe_params({n: orig[n][ei] for n in BANKS}, part,
                                     cm, cfg.activation)
            for n in BANKS:
                shared, routed = views[n]
                shared[li, ei] = conv["shared"][n]
                routed[li, ei] = conv["routed"][n]
            per_expert.append({k: conv[k] for k in ("router", "u", "bias")})
        small.append(tree_stack(per_expert))
        del orig
    cmoe = tree_stack(small)
    cmoe["shared"] = {n: views[n][0] for n in BANKS}
    cmoe["routed"] = {n: views[n][1] for n in BANKS}

    new_moe = dict(moe)
    new_blocks = {k: v for k, v in blocks.items() if k != "moe"}
    new_blocks["moe"] = new_moe
    new_blocks["cmoe"] = cmoe
    new_params = {**params, key: new_blocks}
    new_model = build_model(cfg.with_cmoe(cm), use_kernel=model.use_kernel,
                            backend=model.backend, device=model.device)
    if x_all.is_cuda:
        torch.cuda.synchronize(x_all.device)
    report = HierarchicalReport(time.perf_counter() - t0, lyr, e,
                                seconds_profile=t_profile,
                                seconds_cluster=t_cluster)
    return new_model, new_params, report


# ------------------------------------------------------------- runtime

def dead_rows_to_sentinel(flat_sub: torch.Tensor, occ: torch.Tensor,
                          sentinel: int) -> torch.Tensor:
    """Re-aim the sub-assignments of unoccupied outer layout rows at the
    flat bank's sentinel id: ``routed_experts`` masks those rows through
    ``valid`` anyway and no live row reads them, so the output is the same
    bits, and ``moe_gather`` gives the sentinel a zero row without loading
    weights (at a 4-token decode ~1144 outer rows carry 24 live ones)."""
    return torch.where(occ[:, None], flat_sub,
                       torch.full_like(flat_sub, sentinel))


def hierarchical_moe_ffn(x: torch.Tensor, p: dict, cfg, *,
                         use_kernel: bool = False,
                         backend: Optional[str] = None,
                         phase: str = "prefill",
                         valid: Optional[torch.Tensor] = None,
                         k_row: Optional[torch.Tensor] = None):
    """Two-level MoE forward on a converted block. x: (B, S, d); p the
    whole block dict ({"moe", "cmoe", ...}).

    valid: optional (B*S, 1) bool — False rows (padded serving prompts)
    are re-aimed at the out-of-range expert before the outer sort, so
    they occupy no layout row and take no load share.
    k_row: optional (B*S,) per-token effective SUB-level k in [1,
    cm.top_k]. Each token's k rides the outer layout permutation to its
    rows, where sub-assignments past it get a zero gate and the flattened
    bank's out-of-range id E*N_r' (never owner*N_r'+N_r', which would
    alias the next expert's sub-expert 0).
    Returns (out (B, S, d), aux{load, router_probs_mean, dropped})."""
    moe = cfg.moe
    cm = cfg.cmoe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    t = b * s
    e = moe.num_experts
    k = moe.top_k
    n_r = cm.num_routed
    cp = p["cmoe"]
    act = swish if cfg.activation == "swiglu" else gelu

    # ---- top level (original router, unchanged) ----
    gates, idx, probs = moe_gate(xf, p["moe"], moe)
    flat_e = idx.reshape(-1)
    vmask = None
    if valid is not None:
        vmask = torch.broadcast_to(valid, idx.shape)
        flat_e = torch.where(vmask.reshape(-1), flat_e,
                             torch.full_like(flat_e, e))
    block = RAGGED_BLOCK_PLAIN
    slot, owner, _, p_total = ragged_layout(flat_e, e, block)
    xp = ragged_scatter(xf, k, slot, p_total)                 # (P, d)
    occ = torch.zeros(p_total + 1, dtype=torch.bool, device=x.device)
    occ[slot] = True
    occ = occ[:p_total]
    owner_row = owner.long().repeat_interleave(block)         # (P,)

    def sdot(lhs, bank):
        return segment_dot(lhs, owner, bank, block)

    # ---- sub-level shared experts (always active) ----
    g = sdot(xp, cp["shared"]["wg"])                          # (P, ms)
    u = sdot(xp, cp["shared"]["wu"])
    h_sh = (act(g) * u).to(x.dtype)
    y_shared = sdot(h_sh, cp["shared"]["wd"]).to(x.dtype)

    # ---- sub-level routed: flatten to E*N_r' sub-experts ----
    sg = sdot(xp, cp["router"]["wg_r"])                       # (P, N_r')
    su = sdot(xp, cp["router"]["wu_r"])
    sub_probs = torch.softmax(act(sg) * su, dim=-1)
    bias = cp.get("bias")
    sel2 = sub_probs if bias is None else sub_probs + bias[owner_row]
    _, sub_idx = top_k_lower_first(sel2, cm.top_k)            # (P, k')
    p_sel = torch.gather(sub_probs, 1, sub_idx)
    u_scale = cp.get("u") if cm.learnable_scaling else None
    if u_scale is not None:
        sub_gates = 1.0 + p_sel * torch.gather(u_scale[owner_row], 1,
                                               sub_idx)
    else:
        sub_gates = torch.ones_like(p_sel)

    flat_sub = owner_row[:, None] * n_r + sub_idx
    if k_row is not None:
        tok_k = k_row.to(torch.int32).reshape(-1).repeat_interleave(k)
        k_rows = torch.zeros(p_total + 1, dtype=torch.int32, device=x.device)
        k_rows[slot] = tok_k
        sub_live = torch.arange(cm.top_k, dtype=torch.int32,
                                device=x.device)[None, :] < \
            k_rows[:p_total, None]                            # (P, k')
        flat_sub = torch.where(sub_live, flat_sub,
                               torch.full_like(flat_sub, e * n_r))
        sub_gates = sub_gates * sub_live.to(sub_gates.dtype)
    flat_sub = dead_rows_to_sentinel(flat_sub, occ, e * n_r)
    y_routed, _ = routed_experts(
        xp,
        {"wg": cp["routed"]["wg"].reshape(e * n_r, d, -1),
         "wu": cp["routed"]["wu"].reshape(e * n_r, d, -1),
         "wd": cp["routed"]["wd"].reshape(e * n_r, -1, d)},
        sub_gates.to(x.dtype), flat_sub, cfg, backend=backend, phase=phase,
        use_kernel=use_kernel, valid=occ[:, None])

    # ---- combine by inverse permutation, gate-weighted ----
    out = ragged_combine(y_shared + y_routed, slot, gates, vmask, t, k)
    keep = torch.ones_like(idx, dtype=torch.bool) if vmask is None \
        else vmask

    # ---- top-level shared experts (deepseek) ----
    if moe.num_shared > 0 and "shared_wg" in p["moe"]:
        g = matmul(xf, p["moe"]["shared_wg"]).float()
        u2 = matmul(xf, p["moe"]["shared_wu"]).float()
        h = (act(g) * u2).to(x.dtype)
        out = out + matmul(h, p["moe"]["shared_wd"])

    load = torch.zeros(e, dtype=torch.float32, device=x.device)
    load.index_add_(0, idx.reshape(-1), keep.reshape(-1).float())
    aux = {"load": load / (t * k), "router_probs_mean": probs.mean(0),
           "dropped": dropped_pairs(keep, valid, idx.shape)}
    return out.reshape(b, s, d), aux
