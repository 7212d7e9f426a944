"""End-to-end dense -> CMoE model conversion (paper §4, Figure 3). Port of
``repro/core/convert.py``.

Per FFN layer: capture the pre-FFN activations on the calibration batch
(on the model's device, through the dense FFN kernel when the model runs
kernels), compute the hidden states and the ATopK profile on the device,
partition on the host (shared by rate, routed by balanced clustering; the
layers' partitions on a thread pool), and slice the original weights into
the CMoE tree with its analytical router, written over the original FFN's
storage.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.config import CMoEConfig
from repro_torch.core.partition import (build_cmoe_params, converted_views,
                                        partition_profiles)
from repro_torch.core.profiling import profile_hidden
from repro_torch.models.layers import ffn_hidden
from repro_torch.models.model import Model, build_model, tree_stack


@dataclass
class ConversionReport:
    seconds_total: float
    seconds_profile: float
    seconds_cluster: float
    num_layers: int
    parts: list            # PartitionResult per layer
    calib_tokens: int


def check_convertible(cfg) -> None:
    """Raise unless CMoE conversion applies to cfg's family. As in the
    reference, it applies to decoders with a dense gated FFN: the Mamba2
    SSD mixer has no gated neuron basis to split, and the reference
    refuses the ssm and hybrid families alike."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"CMoE conversion does not apply to the {cfg.family!r} family "
            f"({cfg.name}): the Mamba2 SSD mixer has no gated FFN neuron "
            f"basis to split, and the reference converts dense-FFN "
            f"decoders only")


def convert_dense_model(model: Model, params: dict, calib_batch: dict,
                        cm: CMoEConfig):
    """Convert every FFN layer. Returns (cmoe_model, cmoe_params, report).

    The converted tree is a permutation of each layer's neurons (shared
    experts first, then the routed ones), so its banks are written over the
    storage of the original FFN, layer by layer: every layer's profile is
    taken first, the partitions run on a thread pool, and then each layer's
    tree is sliced from its original weights (one layer's copy) and written
    back over its own region. The peak is the model plus one layer's FFN
    and the calibration taps. ``params`` gives up its FFN weights: they
    are removed from its ``blocks["ffn"]``; clone the params first if the
    dense model is still needed.

    The audio family (whisper) converts its decoder: the taps are the
    decoder layers' FFN inputs over a calibration batch that carries
    ``frames``. The encoder's blocks (``enc_blocks``) are left as they are
    and keep running their dense FFN under the converted config."""
    cfg = model.cfg
    check_convertible(cfg)
    if cfg.family not in ("dense", "vlm", "audio"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no dense "
                         f"FFN stack; convert an MoE model with "
                         f"core.hierarchical.convert_moe_model")
    t0 = time.perf_counter()
    taps = model.ffn_inputs(params, calib_batch)             # (L, B, S, d)
    l, b, s, d = taps.shape
    x_all = taps.reshape(l, b * s, d)
    blocks = params["blocks"]
    ffn = blocks["ffn"]
    profiles = []
    for li in range(l):
        h = ffn_hidden(x_all[li], {n: w[li] for n, w in ffn.items()},
                       cfg.activation)
        a, mu = profile_hidden(h, cm.k_activation)
        profiles.append((a.cpu().numpy(), mu.cpu().numpy()))
    del taps, x_all
    t_profile = time.perf_counter() - t0

    t1 = time.perf_counter()
    parts = partition_profiles(profiles, cm)
    t_cluster = time.perf_counter() - t1
    del profiles

    banks = {n: ffn.pop(n).contiguous() for n in list(ffn)}
    ms = cm.num_shared * (banks["wd"].shape[1] // cm.num_experts)
    # each (L, d, d_h) / (L, d_h, d) bank as a one-expert MoE bank
    views = {n: tuple(v[:, 0] for v in converted_views(
        w.unsqueeze(1), ms, cm.num_routed, n == "wd"))
        for n, w in banks.items()}
    small = []                                   # router, u, bias per layer
    for li, part in enumerate(parts):
        conv = build_cmoe_params({n: w[li] for n, w in banks.items()}, part,
                                 cm, cfg.activation)
        for n, (shared, routed) in views.items():
            shared[li] = conv["shared"][n]
            routed[li] = conv["routed"][n]
        small.append({k: conv[k] for k in ("router", "u", "bias")})
        del conv
    cmoe = tree_stack(small)
    cmoe["shared"] = {n: v[0] for n, v in views.items()}
    cmoe["routed"] = {n: v[1] for n, v in views.items()}

    new_blocks = {k: v for k, v in blocks.items() if k != "ffn"}
    new_blocks["cmoe"] = cmoe
    new_params = {**params, "blocks": new_blocks}
    new_model = build_model(cfg.with_cmoe(cm), use_kernel=model.use_kernel,
                            backend=model.backend, device=model.device)
    if banks["wd"].is_cuda:
        torch.cuda.synchronize(banks["wd"].device)
    report = ConversionReport(seconds_total=time.perf_counter() - t0,
                              seconds_profile=t_profile,
                              seconds_cluster=t_cluster, num_layers=l,
                              parts=parts, calib_tokens=b * s)
    return new_model, new_params, report


def reconstruction_error(model: Model, params: dict, cmoe_model: Model,
                         cmoe_params: dict, batch: dict) -> float:
    """E_x || F_MoE(x) - F(x) ||^2 on final hidden states (Eq. 2)."""
    h_dense = model.hidden_states(params, batch).float()
    h_moe = cmoe_model.hidden_states(cmoe_params, batch).float()
    diff = h_dense - h_moe
    return float((diff * diff).sum(dim=-1).mean())
