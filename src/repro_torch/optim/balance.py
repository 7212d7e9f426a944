"""Aux-loss-free load balancing (paper §4.3 / DeepSeek-v3): after each step,
nudge each expert's selection bias against its measured utilization. Port
of ``repro/optim/balance.py``."""
from __future__ import annotations

import torch

from repro_torch.core.router import update_balance_bias


def _per_layer(bias: torch.Tensor, moe_load: torch.Tensor, gamma: float
               ) -> torch.Tensor:
    """update_balance_bias on each layer's row (the reference's vmap)."""
    return torch.stack([update_balance_bias(bias[i], moe_load[i], gamma)
                        for i in range(bias.shape[0])])


def apply_balance_update(params: dict, moe_load, *, gamma: float = 1e-3
                         ) -> dict:
    """moe_load: (L, N_r) utilization per layer (from the loss metrics).
    Returns params with ``blocks["cmoe"]["bias"]`` (a converted CMoE
    tree) or ``blocks["moe"]["balance_bias"]`` (a pretrained MoE) updated,
    out of band: no gradient is involved. An interleaved stack (llama4)
    keeps its MoE layers under ``blocks_moe``. Other leaves are shared
    with the params given."""
    blocks_key = "blocks" if "blocks" in params else "blocks_moe"
    blocks = dict(params[blocks_key])
    with torch.no_grad():
        if "cmoe" in blocks and "bias" in blocks["cmoe"]:
            tree = dict(blocks["cmoe"])
            tree["bias"] = _per_layer(tree["bias"], moe_load, gamma)
            blocks["cmoe"] = tree
        elif "moe" in blocks and "balance_bias" in blocks["moe"]:
            tree = dict(blocks["moe"])
            tree["balance_bias"] = _per_layer(tree["balance_bias"],
                                              moe_load, gamma)
            blocks["moe"] = tree
    return {**params, blocks_key: blocks}
