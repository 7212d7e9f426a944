"""Grouped routed-expert FFN over the ragged, block-aligned layout.

Port of the Pallas kernel ``repro/kernels/moe_gmm.py::moe_gmm_ragged``:
xp (P, d) holds expert-sorted rows, every (block_c, d) row tile belongs to
one expert ``owner[tile]``, and each tile runs the fused GLU FFN with its
owner's weights. The CUDA kernel is ``csrc/moe_gmm.cu`` over the shared core
``csrc/ffn_core.cuh``; the plain version below repeats its arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, check_float_operands,
                                        check_ids, raise_on_error, stream_ptr)

# rows of one CUDA tile (kBM in csrc/ffn_core.cuh): the kernel takes exactly
# this layout block, so every tile has one owner
CUDA_TILE_ROWS = 64


def moe_gmm_ragged_plain(xp: torch.Tensor, owner: torch.Tensor,
                         wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                         activation: str = "swiglu",
                         block_c: int = CUDA_TILE_ROWS) -> torch.Tensor:
    """xp: (P, d), P % block_c == 0; owner: (P / block_c,) expert per row
    tile; wg/wu: (E, d, m); wd: (E, m, d) -> (P, d) in xp's dtype."""
    p, d = xp.shape
    own = owner.long()
    xb = xp.reshape(p // block_c, block_c, d).float()
    g = torch.bmm(xb, wg[own].float())
    u = torch.bmm(xb, wu[own].float())
    h = (act(activation)(g) * u).to(xp.dtype)
    return torch.bmm(h.float(), wd[own].float()).to(xp.dtype).reshape(p, d)


def moe_gmm_ragged_cuda(xp: torch.Tensor, owner: torch.Tensor,
                        wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                        activation: str = "swiglu",
                        block_c: int = CUDA_TILE_ROWS) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    dt, dev = check_float_operands(xp, wg, wu, wd)
    p, d = xp.shape
    e, _, m = wg.shape
    if block_c != CUDA_TILE_ROWS or p % block_c:
        raise ValueError(f"the kernel takes block_c={CUDA_TILE_ROWS} and P "
                         f"a multiple of it; got block_c={block_c}, P={p}")
    if wg.shape != (e, d, m) or wu.shape != (e, d, m) or \
            wd.shape != (e, m, d):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wu {tuple(wu.shape)},"
                         f" wd {tuple(wd.shape)} do not match d={d}")
    check_ids(owner, p // block_c, dev)
    h = torch.empty((p, m), dtype=xp.dtype, device=dev)
    out = torch.empty((p, d), dtype=xp.dtype, device=dev)
    err = build.entry("moe_gmm")(
        xp.data_ptr(), owner.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), h.data_ptr(), out.data_ptr(), p, d, m, e, block_c,
        dt, act_code(activation), stream_ptr(dev))
    raise_on_error(err, "moe_gmm_ragged")
    return out
