"""End-to-end dense -> CMoE model conversion (paper §4, Figure 3). Port of
``repro/core/convert.py``.

Per FFN layer: capture the pre-FFN activations on the calibration batch
(on the model's device, through the dense FFN kernel when the model runs
kernels), compute the hidden states and the ATopK profile on the device,
partition on the host (shared by rate, routed by balanced clustering), and
slice the original weights into the CMoE tree with its analytical router.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.config import CMoEConfig
from repro_torch.core.partition import build_cmoe_params, partition_neurons
from repro_torch.core.profiling import profile_hidden
from repro_torch.models.layers import ffn_hidden
from repro_torch.models.model import Model, build_model, tree_map, tree_stack


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
    """Convert every FFN layer. Returns (cmoe_model, cmoe_params, report)."""
    cfg = model.cfg
    check_convertible(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"conversion of family {cfg.family!r} is "
                                  f"not ported yet")
    t0 = time.perf_counter()
    taps = model.ffn_inputs(params, calib_batch)             # (L, B, S, d)
    l, b, s, d = taps.shape
    x_all = taps.reshape(l, b * s, d)
    if x_all.is_cuda:
        torch.cuda.synchronize(x_all.device)
    t_profile = time.perf_counter() - t0

    blocks = params["blocks"]
    cmoe_layers, parts = [], []
    t1 = time.perf_counter()
    for li in range(l):
        ffn_l = tree_map(lambda a: a[li], blocks["ffn"])
        h = ffn_hidden(x_all[li], ffn_l, cfg.activation)
        a, mu = profile_hidden(h, cm.k_activation)
        part = partition_neurons(a.cpu().numpy(), mu.cpu().numpy(), cm)
        cmoe_layers.append(build_cmoe_params(ffn_l, part, cm,
                                             cfg.activation))
        parts.append(part)
    t_cluster = time.perf_counter() - t1

    new_blocks = {k: v for k, v in blocks.items() if k != "ffn"}
    new_blocks["cmoe"] = tree_stack(cmoe_layers)
    new_params = {**params, "blocks": new_blocks}
    new_model = build_model(cfg.with_cmoe(cm), use_kernel=model.use_kernel,
                            backend=model.backend, device=model.device)
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
