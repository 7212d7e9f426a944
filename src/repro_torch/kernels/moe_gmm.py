"""Grouped routed-expert FFNs: the ragged layout and dense capacity buffers.

Port of the two Pallas kernels of ``repro/kernels/moe_gmm.py``:

* ``moe_gmm_ragged``: xp (P, d) holds expert-sorted rows, every (block_c,
  d) row tile belongs to one expert ``owner[tile]``, and each tile runs the
  fused GLU FFN with its owner's weights;
* ``moe_gmm``: dense (E, C, d) capacity buffers, row block e runs expert
  e's GLU FFN (the bounded-buffer path of ``core.experts``).

Both are entry points of ``csrc/moe_gmm.cu``, each with two CUDA kernels,
and ``route(dtype, d, m)`` picks between them: bfloat16 with d and m
multiples of 8 (every config's expert widths) runs on the tensor cores
(``csrc/ffn_tc.cuh``: TMA and ``wgmma``), everything else on the SIMT core
``csrc/ffn_core.cuh``. The plain versions below repeat their arithmetic:
g and u in fp32, h rounded to the input dtype, the down product summed in
fp32 and cast once.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, aligned16,
                                        check_float_operands, check_ids,
                                        ffn_route, raise_on_error,
                                        stream_ptr, tc_or_simt)

# rows of one CUDA tile (kBM in csrc/ffn_core.cuh, kRows in csrc/ffn_tc.cuh):
# the kernels take exactly this layout block, so every tile has one owner
CUDA_TILE_ROWS = 64
# launches of each route since the last reset: moe_gmm's and
# moe_gmm_ragged's
ROUTE_LAUNCHES: Counter = Counter()
RAGGED_ROUTE_LAUNCHES: Counter = Counter()
route = ffn_route     # route(dtype, d, m): "tensor_core" or "simt"


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
                        block_c: int = CUDA_TILE_ROWS,
                        path: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel that ``route`` names (or ``path``: "simt" runs the
    SIMT core on any operands, to time it beside the other) on the current
    stream."""
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
    path = tc_or_simt(route(xp.dtype, d, m), path)
    h = torch.empty((p, m), dtype=xp.dtype, device=dev)
    out = torch.empty((p, d), dtype=xp.dtype, device=dev)
    if path == "tensor_core":
        xp, wg, wu, wd = (aligned16(a) for a in (xp, wg, wu, wd))
        err = build.entry("moe_gmm_ragged_tc_launch")(
            xp.data_ptr(), owner.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), h.data_ptr(), out.data_ptr(), p, d, m, e,
            act_code(activation), stream_ptr(dev))
    else:
        err = build.entry("moe_gmm_ragged_launch")(
            xp.data_ptr(), owner.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), h.data_ptr(), out.data_ptr(), p, d, m, e,
            block_c, dt, act_code(activation), stream_ptr(dev))
    raise_on_error(err, f"moe_gmm_ragged ({path})")
    RAGGED_ROUTE_LAUNCHES[path] += 1
    return out


def moe_gmm_plain(xbuf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, activation: str = "swiglu"
                  ) -> torch.Tensor:
    """xbuf: (E, C, d); wg/wu: (E, d, m); wd: (E, m, d) -> (E, C, d) in
    xbuf's dtype."""
    x = xbuf.float()
    g = torch.bmm(x, wg.float())
    u = torch.bmm(x, wu.float())
    h = (act(activation)(g) * u).to(xbuf.dtype)
    return torch.bmm(h.float(), wd.float()).to(xbuf.dtype)


def moe_gmm_cuda(xbuf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor, activation: str = "swiglu",
                 path: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel that ``route`` names (or ``path``: "simt" runs the
    SIMT core on any operands, to time it beside the other) on the current
    stream. Any C and m: the kernels mask the rows past C in each expert's
    last row tile and the columns past m, so nothing is padded."""
    dt, dev = check_float_operands(xbuf, wg, wu, wd)
    if xbuf.dim() != 3:
        raise ValueError(f"xbuf must be (E, C, d); got {tuple(xbuf.shape)}")
    e, c, d = xbuf.shape
    m = wg.shape[-1]
    if wg.shape != (e, d, m) or wu.shape != (e, d, m) or \
            wd.shape != (e, m, d):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wu {tuple(wu.shape)},"
                         f" wd {tuple(wd.shape)} do not match xbuf "
                         f"{tuple(xbuf.shape)}")
    path = tc_or_simt(route(xbuf.dtype, d, m), path)
    h = torch.empty((e, c, m), dtype=xbuf.dtype, device=dev)
    out = torch.empty((e, c, d), dtype=xbuf.dtype, device=dev)
    if path == "tensor_core":
        xbuf, wg, wu, wd = (aligned16(a) for a in (xbuf, wg, wu, wd))
        err = build.entry("moe_gmm_tc_launch")(
            xbuf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), e, c, d, m, act_code(activation),
            stream_ptr(dev))
    else:
        err = build.entry("moe_gmm_launch")(
            xbuf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), e, c, d, m, dt,
            act_code(activation), stream_ptr(dev))
    raise_on_error(err, f"moe_gmm ({path})")
    ROUTE_LAUNCHES[path] += 1
    return out
