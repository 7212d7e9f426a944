"""Single-query attention over a contiguous (BH, T, D) cache, keys past
``pos`` masked.

Port of the Pallas kernel ``repro/kernels/flash_decode.py::flash_decode``.
The CUDA source is ``csrc/flash_decode.cu`` (its note states the bound on
an H100 and the design). It holds two hand-written kernels, and
``route(dtype, D)`` picks one: "split", the split-KV decode core of
``csrc/decode_split.cuh`` shared with ``paged_attn_decode``, where a row is
whole 16-byte vectors (D x itemsize a multiple of 16: every head width in
``configs/``); "simt", the one-block-a-row kernel, for every other D. The
plain version below is the oracle ``repro/kernels/ref.py::
flash_decode_ref``: fp32 scores scaled by D^-0.5, keys at positions > pos
scored -1e30, a softmax over the T keys, p rounded to v's dtype before the
PV product, the output in v's dtype.

``pos`` is one last valid index shared by every row, as in the reference.
The CUDA kernels read it from a device int32, so a call makes no host sync,
and read no key past min(pos, T - 1). Unlike the JAX wrapper, which pads T
to its block so that a pos >= T lets its padded zero keys into the
softmax, nothing is padded: keys at and past T do not exist for either
version.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (aligned16, check_float_operands,
                                        decode_workspace, raise_on_error,
                                        stream_ptr)

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # csrc/flash_decode.cu: both kernels
# launches of each route since the last reset: which kernel a call ran
ROUTE_LAUNCHES: Counter = Counter()


def route(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that serves a call: "split" (the split-KV core,
    csrc/decode_split.cuh) where D x itemsize is a multiple of 16 up to
    MAX_HEAD_DIM, the 16-byte vectors its cp.async ring copies; else
    "simt" (bfloat16 D 100, float32 D 6)."""
    if (d * dtype.itemsize) % 16 == 0 and 1 <= d <= MAX_HEAD_DIM:
        return "split"
    return "simt"


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
    """Launch the kernel that ``route`` names on the current stream. pos
    must be a contiguous one-element int32 tensor on the operands'
    device."""
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
    path = route(q.dtype, d)
    scale = float(d ** -0.5)
    if path == "split":
        # its 16-byte copies need 16-byte aligned bases (a view may start
        # off that grid)
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
        out = torch.empty_like(q)
        nch, _work, part_acc, part_ml = decode_workspace(bh, 1, d, t, dev)
        err = build.entry("flash_decode_split_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part_acc, part_ml, bh, t, d, nch, scale, dt,
            stream_ptr(dev))
    else:
        out = torch.empty_like(q)
        err = build.entry("flash_decode_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), bh, t, d, scale, dt, stream_ptr(dev))
    raise_on_error(err, f"flash_decode ({path})")
    ROUTE_LAUNCHES[path] += 1
    return out
