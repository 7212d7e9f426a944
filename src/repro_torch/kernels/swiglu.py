"""Fused dense GLU FFN: out = (act(x Wg) * (x Wu)) Wd.

Port of the Pallas kernel ``repro/kernels/swiglu.py::swiglu_ffn``. The CUDA
source is ``csrc/swiglu.cu`` (its note states the bound on an H100). It has
two entries, and ``route(dtype, d, f)`` picks one: bfloat16 with d and f
multiples of 8 (every config's widths) runs on the tensor cores
(``csrc/ffn_tc.cuh``: TMA and ``wgmma``), everything else on the SIMT core
``csrc/ffn_core.cuh`` in fp32 FMA. The plain version below repeats their
arithmetic in PyTorch and is what a CPU tensor runs. All keep g and u in
fp32 and round h to x's dtype before the down product, as the Pallas body
does.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, aligned16,
                                        check_float_operands, ffn_route,
                                        raise_on_error, stream_ptr,
                                        tc_or_simt)

# launches of each route since the last reset: which kernel a call ran
ROUTE_LAUNCHES: Counter = Counter()
route = ffn_route     # route(dtype, d, f): "tensor_core" or "simt"


def swiglu_ffn_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor, activation: str = "swiglu"
                     ) -> torch.Tensor:
    """x: (T, d); wg/wu: (d, f); wd: (f, d) -> (T, d) in x's dtype."""
    xf = x.float()
    g = xf @ wg.float()
    u = xf @ wu.float()
    h = (act(activation)(g) * u).to(x.dtype)
    return (h.float() @ wd.float()).to(x.dtype)


def swiglu_ffn_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, activation: str = "swiglu",
                    path: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel that ``route`` names (or ``path``: "simt" runs the
    SIMT core on any operands, to time it beside the other) on the current
    stream. x: (T, d)."""
    dt, dev = check_float_operands(x, wg, wu, wd)
    t, d = x.shape
    f = wg.shape[1]
    if wg.shape != (d, f) or wu.shape != (d, f) or wd.shape != (f, d):
        raise ValueError(f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    path = tc_or_simt(route(x.dtype, d, f), path)
    h = torch.empty((t, f), dtype=x.dtype, device=dev)
    out = torch.empty((t, d), dtype=x.dtype, device=dev)
    if path == "tensor_core":
        x, wg, wu, wd = (aligned16(a) for a in (x, wg, wu, wd))
        err = build.entry("swiglu_ffn_tc_launch")(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), t, d, f, act_code(activation),
            stream_ptr(dev))
    else:
        err = build.entry("swiglu_ffn_launch")(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), t, d, f, dt, act_code(activation),
            stream_ptr(dev))
    raise_on_error(err, f"swiglu_ffn ({path})")
    ROUTE_LAUNCHES[path] += 1
    return out
