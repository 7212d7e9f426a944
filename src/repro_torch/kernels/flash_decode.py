"""Single-query attention over a contiguous (BH, T, D) cache, keys past
``pos`` masked.

Port of the Pallas kernel ``repro/kernels/flash_decode.py::flash_decode``.
The CUDA kernel is ``csrc/flash_decode.cu`` (its source note states the
bound on an H100 and the design); the plain version below is the oracle
``repro/kernels/ref.py::flash_decode_ref``: fp32 scores scaled by D^-0.5,
keys at positions > pos scored -1e30, a softmax over the T keys, p rounded
to v's dtype before the PV product, the output in v's dtype.

``pos`` is one last valid index shared by every row, as in the reference.
The CUDA kernel reads it from a device int32, so a call makes no host sync,
and reads no key past min(pos, T - 1). Unlike the JAX wrapper, which pads T
to its block so that a pos >= T lets its padded zero keys into the
softmax, nothing is padded: keys at and past T do not exist for either
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_float_operands, raise_on_error,
                                        stream_ptr)

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # csrc/flash_decode.cu: channels tid, tid + 128


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos) -> torch.Tensor:
    """q: (BH, 1, D); k/v: (BH, T, D); pos: an int or a one-element
    integer tensor, the last valid index. Returns (BH, 1, D) in v's
    dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    p_t = torch.as_tensor(pos, device=k.device).reshape(())
    keep = torch.arange(k.shape[1], device=k.device) <= p_t
    s = s.masked_fill(~keep[None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v.float()).to(v.dtype)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. pos must be a
    contiguous one-element int32 tensor on the operands' device."""
    dt, dev = check_float_operands(q, k, v)
    if q.dim() != 3 or q.shape[1] != 1 or k.dim() != 3 or \
            k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not form (BH, 1, D) / (BH, "
                         f"T, D) decode operands")
    bh, _, d = q.shape
    t = k.shape[1]
    if bh < 1 or t < 1:
        raise ValueError(f"empty decode call: BH={bh}, T={t}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes D from 1 to {MAX_HEAD_DIM}; "
                         f"got {d}")
    if pos.dtype != torch.int32 or pos.device != dev or pos.numel() != 1 \
            or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous one-element int32 "
                         f"tensor on {dev}; got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    out = torch.empty_like(q)
    err = build.entry("flash_decode_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), bh, t, d, float(d ** -0.5), dt, stream_ptr(dev))
    raise_on_error(err, "flash_decode")
    return out
