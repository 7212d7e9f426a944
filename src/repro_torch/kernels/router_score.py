"""The CMoE analytical router's fused scoring: s = act(x Wg_R) * (x Wu_R).

Port of the Pallas kernel ``repro/kernels/router_score.py::router_score``.
The CUDA kernel is ``csrc/router_score.cu`` (its source note states the
bound on an H100 and the design); the plain version below is
``ref.router_score_ref``: g and u are fp32 sums that are NOT rounded to x's
dtype, unlike ``core.router.router_scores``, which rounds the matmul
outputs. The output is (T, N_r) float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, check_float_operands,
                                        raise_on_error, stream_ptr)

# widest N_r the kernel's register tiles take (csrc/router_score.cu)
MAX_ROUTER_COLS = 16


def router_score_plain(x: torch.Tensor, wg_r: torch.Tensor,
                       wu_r: torch.Tensor, activation: str = "swiglu"
                       ) -> torch.Tensor:
    """x: (T, d); wg_r/wu_r: (d, N_r) -> scores (T, N_r) float32."""
    xf = x.float()
    g = xf @ wg_r.float()
    u = xf @ wu_r.float()
    return act(activation)(g) * u


def router_score_cuda(x: torch.Tensor, wg_r: torch.Tensor,
                      wu_r: torch.Tensor, activation: str = "swiglu"
                      ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Any T (the kernel
    masks the ragged row block; nothing is padded)."""
    dt, dev = check_float_operands(x, wg_r, wu_r)
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d); got {tuple(x.shape)}")
    t, d = x.shape
    n_r = wg_r.shape[-1]
    if wg_r.shape != (d, n_r) or wu_r.shape != (d, n_r):
        raise ValueError(f"router weights wg_r {tuple(wg_r.shape)}, wu_r "
                         f"{tuple(wu_r.shape)} do not match d={d}")
    if not 1 <= n_r <= MAX_ROUTER_COLS:
        raise ValueError(f"the kernel takes 1 to {MAX_ROUTER_COLS} router "
                         f"columns; got {n_r}")
    out = torch.empty((t, n_r), dtype=torch.float32, device=dev)
    err = build.entry("router_score_launch")(
        x.data_ptr(), wg_r.data_ptr(), wu_r.data_ptr(), out.data_ptr(), t, d,
        n_r, dt, act_code(activation), stream_ptr(dev))
    raise_on_error(err, "router_score")
    return out
