"""Softmax attention over (BH, S, D) queries and (BH, T, D) keys and values,
causal (top-left mask) or full, with an online softmax.

Port of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``. The CUDA source is ``csrc/flash_attention.cu`` (its note
states the bound on an H100 and the design). It holds two hand-written
kernels, and ``route(dtype, D)`` picks one: bfloat16 with D a multiple of
16 up to 256 (every head width in ``configs/``) runs on the tensor cores
(``wgmma``), everything else on the fp32 FMA units. The plain version
below is the oracle ``repro/kernels/ref.py::flash_attention_ref``: fp32
scores scaled by D^-0.5, under ``causal`` the mask kpos <= qpos (top-left,
so with S > T the last S - T queries see every key), a softmax, p rounded
to v's dtype before the PV product, fp32 sums, the output in v's dtype.

Unlike the JAX wrapper, which pads S and T to its blocks, nothing is padded:
the CUDA kernel masks the ragged S and T edges itself, so it computes the
oracle's function for every S and T, including the causal S > T and the
non-causal ragged T that the JAX wrapper gets wrong or hands to the
oracle. There are no block arguments: the kernel's tiles are its own.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_float_operands, raise_on_error,
                                        stream_ptr)

NEG_INF = -1e30
# csrc/flash_attention.cu: the widest head it takes (gemma3-4b's 256 is
# the widest in configs/)
MAX_HEAD_DIM = 256
# launches of each route since the last reset: which kernel a call ran
ROUTE_LAUNCHES: Counter = Counter()
_ENTRIES = {"tensor_core": "flash_attention_tc_launch",
            "simt": "flash_attention_launch"}


def route(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that serves a call: "tensor_core" for bfloat16 with
    D a multiple of 16 up to MAX_HEAD_DIM, else "simt" (float32 at any D,
    bfloat16 off the 16 grid)."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= MAX_HEAD_DIM:
        return "tensor_core"
    return "simt"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BH, T, D) -> (BH, S, D) in v's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if causal:
        sq, tk = q.shape[1], k.shape[1]
        keep = torch.arange(tk, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(~keep[None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v.float()).to(v.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel that ``route`` names on the current stream. Any S,
    T >= 1 and D from 1 to MAX_HEAD_DIM."""
    dt, dev = check_float_operands(q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not form (BH, S, D) / (BH, "
                         f"T, D) attention operands")
    bh, s, d = q.shape
    t = k.shape[1]
    if bh < 1 or s < 1 or t < 1:
        raise ValueError(f"empty attention call: BH={bh}, S={s}, T={t}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes D from 1 to {MAX_HEAD_DIM}; "
                         f"got {d}")
    path = route(q.dtype, d)
    args = [float(d ** -0.5), int(bool(causal))]
    if path == "tensor_core":
        # its TMA loads need a 16-byte aligned base (D % 16 == 0 keeps the
        # rows on that grid; a view may start off it)
        q, k, v = (a if a.data_ptr() % 16 == 0 else a.clone()
                   for a in (q, k, v))
    else:
        args.append(dt)
    out = torch.empty_like(q)
    err = build.entry(_ENTRIES[path])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, t,
        d, *args, stream_ptr(dev))
    raise_on_error(err, f"flash_attention ({path})")
    ROUTE_LAUNCHES[path] += 1
    return out
