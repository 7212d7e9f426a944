"""Per-assignment expert FFN rows for decode, with no gathered weight copies.

Port of the Pallas kernel ``repro/kernels/moe_gather.py::moe_gather``: row
i of the (T*k, d) output is expert ``eidx[i]``'s GLU FFN of token
``xf[i // top_k]``; the sentinel id E (an invalidated assignment) loads no
weights, runs no FLOPs and yields an exact zero row. The CUDA source is
``csrc/moe_gather.cu``, with two kernels, and ``route(dtype, d, m)`` picks
one: bfloat16 with d and m multiples of 8 (every config's expert widths)
runs on the tensor cores (``csrc/ffn_tc.cuh``: the block of the first row
of each run of 64 rows of one expert gathers them and streams that
expert's weights once), everything else on the SIMT core
``csrc/ffn_core.cuh``. The plain version below repeats their arithmetic
(gathering weight copies, which only the plain version does).
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

# launches of each route since the last reset: which kernel a call ran
ROUTE_LAUNCHES: Counter = Counter()
route = ffn_route     # route(dtype, d, m): "tensor_core" or "simt"


def moe_gather_plain(xf: torch.Tensor, eidx: torch.Tensor, wg: torch.Tensor,
                     wu: torch.Tensor, wd: torch.Tensor, *, top_k: int,
                     activation: str = "swiglu") -> torch.Tensor:
    """xf: (T, d); eidx: (T*k,) ids in [0, E]; wg/wu: (E, d, m);
    wd: (E, m, d) -> (T*k, d) rows, pre gate-combine."""
    n_e = wg.shape[0]
    ids = eidx.long()
    dead = ids >= n_e
    ids = ids.clamp(0, n_e - 1)
    xr = xf.repeat_interleave(top_k, dim=0).float().unsqueeze(1)  # (n,1,d)
    g = torch.bmm(xr, wg[ids].float())
    u = torch.bmm(xr, wu[ids].float())
    h = (act(activation)(g) * u).to(xf.dtype)
    y = torch.bmm(h.float(), wd[ids].float()).squeeze(1).to(xf.dtype)
    return y.masked_fill(dead[:, None], 0)


def moe_gather_cuda(xf: torch.Tensor, eidx: torch.Tensor, wg: torch.Tensor,
                    wu: torch.Tensor, wd: torch.Tensor, *, top_k: int,
                    activation: str = "swiglu", path: Optional[str] = None
                    ) -> torch.Tensor:
    """Launch the kernel that ``route`` names (or ``path``: "simt" runs the
    SIMT core on any operands, to time it beside the other) on the current
    stream. eidx must already be clamped to [0, E]."""
    dt, dev = check_float_operands(xf, wg, wu, wd)
    t, d = xf.shape
    e, _, m = wg.shape
    n = t * top_k
    if wg.shape != (e, d, m) or wu.shape != (e, d, m) or \
            wd.shape != (e, m, d):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wu {tuple(wu.shape)},"
                         f" wd {tuple(wd.shape)} do not match d={d}")
    check_ids(eidx, n, dev)
    path = tc_or_simt(route(xf.dtype, d, m), path)
    h = torch.empty((n, m), dtype=xf.dtype, device=dev)
    out = torch.empty((n, d), dtype=xf.dtype, device=dev)
    if path == "tensor_core":
        xf, wg, wu, wd = (aligned16(a) for a in (xf, wg, wu, wd))
        err = build.entry("moe_gather_tc_launch")(
            xf.data_ptr(), eidx.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), h.data_ptr(), out.data_ptr(), t, n, d, m, e,
            top_k, act_code(activation), stream_ptr(dev))
    else:
        err = build.entry("moe_gather_launch")(
            xf.data_ptr(), eidx.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), h.data_ptr(), out.data_ptr(), n, d, m, e, top_k,
            dt, act_code(activation), stream_ptr(dev))
    raise_on_error(err, f"moe_gather ({path})")
    ROUTE_LAUNCHES[path] += 1
    return out
