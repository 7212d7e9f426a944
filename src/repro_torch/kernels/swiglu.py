"""Fused dense GLU FFN: out = (act(x Wg) * (x Wu)) Wd.

Port of the Pallas kernel ``repro/kernels/swiglu.py::swiglu_ffn``. The CUDA
kernel is ``csrc/swiglu.cu`` over the shared core ``csrc/ffn_core.cuh``
(its source note states the bound on an H100 and the design); the plain
version below repeats its arithmetic in PyTorch and is what a CPU tensor
runs. Both keep g and u in fp32 and round h to x's dtype before the down
product, as the Pallas body does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (act, act_code, check_float_operands,
                                        raise_on_error, stream_ptr)


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
                    wd: torch.Tensor, activation: str = "swiglu"
                    ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. x: (T, d)."""
    dt, dev = check_float_operands(x, wg, wu, wd)
    t, d = x.shape
    f = wg.shape[1]
    if wg.shape != (d, f) or wu.shape != (d, f) or wd.shape != (f, d):
        raise ValueError(f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    h = torch.empty((t, f), dtype=x.dtype, device=dev)
    out = torch.empty((t, d), dtype=x.dtype, device=dev)
    err = build.entry("swiglu")(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        h.data_ptr(), out.data_ptr(), t, d, f, dt, act_code(activation),
        stream_ptr(dev))
    raise_on_error(err, "swiglu_ffn")
    return out
