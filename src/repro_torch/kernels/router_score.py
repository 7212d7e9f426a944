"""The CMoE analytical router's fused scoring: s = act(x Wg_R) * (x Wu_R).

Port of the Pallas kernel ``repro/kernels/router_score.py::router_score``.
The CUDA kernel is ``csrc/router_score.cu`` (its source note states the
bound on an H100 and the design; ``plan`` below is its launch plan); the
plain version below is
``ref.router_score_ref``: g and u are fp32 sums that are NOT rounded to x's
dtype, unlike ``core.router.router_scores``, which rounds the matmul
outputs. The output is (T, N_r) float32.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, aligned16,
                                        check_float_operands, raise_on_error,
                                        stream_ptr)

# csrc/router_score.cu: the widest N_r it unrolls for, the warps of a block
# (one row a warp at a time), the shared memory the staged weights may take
# and the most blocks a call launches (8 an SM on an H100's 132)
MAX_ROUTER_COLS = 16
ROUTER_WARPS = 4
ROUTER_SMEM = 48 * 1024
ROUTER_MAX_BLOCKS = 8 * 132


@functools.lru_cache(maxsize=256)   # host time on every launch
def plan(t: int, d: int, nr: int, itemsize: int) -> dict:
    """The CUDA kernel's launch for x (T, d) of `itemsize` bytes and N_r
    columns: `blocks` of ROUTER_WARPS warps, each warp taking
    `rows_per_warp` rows one at a time (T 512: 128 blocks, one row a warp);
    the weights staged in chunks of `chunk` rows of d (`chunks` of them,
    `smem` bytes; the whole of d where it fits ROUTER_SMEM). A lane reads
    16-byte vectors of x, so d x itemsize must be a multiple of 16. The
    dict is shared between calls: read it, do not change it."""
    vec = 16 // itemsize
    if d % vec or not 1 <= nr <= MAX_ROUTER_COLS or t < 1:
        raise ValueError(f"the kernel takes d a multiple of {vec}, N_r from "
                         f"1 to {MAX_ROUTER_COLS} and T >= 1; got T={t}, "
                         f"d={d}, N_r={nr}")
    groups = d // vec               # x vectors a row
    group_bytes = 2 * 16 * (nr | 1)  # Wg_R's and Wu_R's rows for one
    fit = ROUTER_SMEM // group_bytes
    cg = groups if groups <= fit else fit // 32 * 32
    blocks = min(-(-t // ROUTER_WARPS), ROUTER_MAX_BLOCKS)
    return dict(blocks=blocks,
                rows_per_warp=-(-t // (blocks * ROUTER_WARPS)),
                chunk=cg * vec, chunks=-(-groups // cg),
                smem=cg * group_bytes)


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
    """Launch the CUDA kernel on the current stream with ``plan``'s grid.
    Any T (nothing is padded); d x itemsize a multiple of 16."""
    dt, dev = check_float_operands(x, wg_r, wu_r)
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d); got {tuple(x.shape)}")
    t, d = x.shape
    n_r = wg_r.shape[-1]
    if wg_r.shape != (d, n_r) or wu_r.shape != (d, n_r):
        raise ValueError(f"router weights wg_r {tuple(wg_r.shape)}, wu_r "
                         f"{tuple(wu_r.shape)} do not match d={d}")
    out = torch.empty((t, n_r), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    pl = plan(t, d, n_r, x.element_size())
    # its 16-byte loads need 16-byte aligned bases (a view may start off
    # that grid)
    x, wg_r, wu_r = aligned16(x), aligned16(wg_r), aligned16(wu_r)
    err = build.entry("router_score_launch")(
        x.data_ptr(), wg_r.data_ptr(), wu_r.data_ptr(), out.data_ptr(), t, d,
        n_r, pl["blocks"], pl["chunk"], pl["rows_per_warp"], dt,
        act_code(activation), stream_ptr(dev))
    raise_on_error(err, "router_score")
    return out
