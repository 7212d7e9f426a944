"""GQA single-query attention straight off a block pool.

Port of the Pallas kernel ``repro/kernels/paged_attention.py::
paged_attn_decode``: row b is one query token at logical position pos[b]
of a lane whose logical block j lives in physical block table[b, j]; it
attends every key at a logical position <= pos[b] (and > pos[b] - window
when window > 0) with an fp32 softmax, p rounded to the pool's dtype before
the PV product. The CUDA kernel is ``csrc/paged_attn.cu`` (its source note
states the bound on an H100 and the design); the plain version below is the
materializing oracle of ``repro/kernels/ref.py::paged_attn_decode_ref``:
assemble each row's logical view through the table, then masked softmax.

The kernel reads keys only up to the row's view (table width x block
size), so a contiguous cache lane, handed over as a pool of one block of
the lane's whole length, is read by the same arithmetic as a paged lane.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_float_operands, raise_on_error,
                                        stream_ptr)

NEG_INF = -1e30

# csrc/paged_attn.cu limits: hd a multiple of 8 (16-byte rows in bf16) and
# at most 256, and grp * hd at most 128 threads x 16 accumulators
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 128 * 16


def paged_attn_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, table: torch.Tensor,
                            pos: torch.Tensor, window: int = 0, *,
                            scale: float) -> torch.Tensor:
    """q: (B, 1, H, hd); k_pool/v_pool: (nblocks, bs, KH, hd); table:
    (B, nblk) int; pos: (B,) int; window 0 = full. Returns (B, 1, H, hd)
    in q's dtype."""
    b, _, h, hd = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    grp = h // kh
    nblk = table.shape[1]
    t = nblk * bs
    tl = table.long()
    k = k_pool[tl].reshape(b, t, kh, hd)
    v = v_pool[tl].reshape(b, t, kh, hd)
    qg = q[:, 0].reshape(b, kh, grp, hd)
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k.float()) * scale
    kpos = torch.arange(t, device=q.device)[None, None, None, :]
    p4 = pos.long().to(q.device)[:, None, None, None]
    mask = kpos <= p4
    if window > 0:
        mask = mask & (kpos > p4 - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", p.float(), v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def paged_attn_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor, window: int = 0, *,
                           scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. table and pos must be
    contiguous int32 on the pools' device."""
    dt, dev = check_float_operands(q, k_pool, v_pool)
    b, s, h, hd = q.shape
    nblocks, bs, kh, hd_k = k_pool.shape
    if s != 1 or hd_k != hd or v_pool.shape != k_pool.shape or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} do "
                         f"not form a single-query GQA call")
    grp = h // kh
    if hd % 8 or hd > MAX_HEAD_DIM or grp * hd > MAX_GROUP_ELEMS:
        raise ValueError(f"the kernel takes hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and grp*hd <= {MAX_GROUP_ELEMS}; "
                         f"got hd={hd}, grp={grp}")
    for name, t, shape in (("table", table, (b, table.shape[-1])),
                           ("pos", pos, (b,))):
        if t.dtype != torch.int32 or t.device != dev or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty_like(q)
    err = build.entry("paged_attn")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, kh, grp, hd, table.shape[1], bs,
        int(window), float(scale), dt, stream_ptr(dev))
    raise_on_error(err, "paged_attn_decode")
    return out
