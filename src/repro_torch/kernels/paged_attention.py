"""Single-query attention straight off a block pool: GQA
(``paged_attn_decode``) and deepseek-v2's absorbed multi-head latent
attention (``mla_paged_decode``).

Port of the Pallas kernel ``repro/kernels/paged_attention.py::
paged_attn_decode``: row b is one query token at logical position pos[b]
of a lane whose logical block j lives in physical block table[b, j]; it
attends every key at a logical position <= pos[b] (and > pos[b] - window
when window > 0) with an fp32 softmax, p rounded to the pool's dtype before
the PV product; a row whose mask keeps no key of its view (pos[b] < 0)
is the uniform average of the view's V rows, as the oracle's softmax over
scores that are all -1e30. The CUDA kernel is ``csrc/paged_attn.cu``, the
entry of the split-KV decode core ``csrc/decode_split.cuh`` (their notes
state the bound on an H100 and the design); the plain version below is the
materializing oracle of ``repro/kernels/ref.py::paged_attn_decode_ref``:
assemble each row's logical view through the table, then masked softmax.

Port of the Pallas kernel ``repro/kernels/paged_attention.py::
mla_paged_decode``: row b scores its absorbed query q_abs (H, r) against
the lane's latents and its rope query q_pe (H, dr) against the lane's rope
keys, masks positions past pos[b], and returns the softmax-weighted latent
o_lat (H, r) in q_abs's dtype (the caller expands it through W_uv); p is
rounded to the latent's dtype before the value product. The CUDA source is
``csrc/mla_paged.cu``. It holds two hand-written kernels, and
``mla_route(dtype, r, dr)`` picks one: "tensor_core" (``csrc/mla_tc.cuh``:
heads as the wgmma M dimension, one latent tile feeding both products,
fixed key chunks of ``common.MLA_CHUNK`` with an in-order merge) for
bfloat16 at deepseek-v2's widths, r 512 and dr 64; "simt" (fp32
arithmetic, one block per row and head group) for float32 and every other
width. The plain version is the oracle ``repro/kernels/ref.py::
mla_paged_decode_ref``.

The kernels read keys only up to the row's view (table width x block
size), so a contiguous cache lane, handed over as a pool of one block of
the lane's whole length, is read by the same arithmetic as a paged lane.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (MLA_CHUNK, aligned16,
                                        check_float_operands,
                                        decode_workspace, raise_on_error,
                                        stream_ptr)

NEG_INF = -1e30

# csrc/paged_attn.cu limits: hd a multiple of 8 (16-byte rows in bf16) and
# at most 256; a query-head group of any width (sliced over blocks)
MAX_HEAD_DIM = 256
# csrc/mla_paged.cu limits: r and dr multiples of 8, at most 1024
MLA_MAX_RANK = 1024
# csrc/mla_tc.cuh's widths (kRank, kRope): deepseek-v2's kv_lora_rank and
# qk_rope_head_dim, the only MLA widths in configs/
MLA_TC_RANK = 512
MLA_TC_ROPE = 64
# launches of each mla_paged_decode route since the last reset
MLA_ROUTE_LAUNCHES: Counter = Counter()


def mla_route(dtype: torch.dtype, r: int, dr: int) -> str:
    """The CUDA kernel that serves an mla_paged_decode call, by dtype and
    widths alone (never by rows, heads or depth): "tensor_core" for
    bfloat16 at r MLA_TC_RANK and dr MLA_TC_ROPE, else "simt"."""
    if dtype == torch.bfloat16 and r == MLA_TC_RANK and dr == MLA_TC_ROPE:
        return "tensor_core"
    return "simt"


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
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; got hd={hd}")
    for name, t, shape in (("table", table, (b, table.shape[-1])),
                           ("pos", pos, (b,))):
        if t.dtype != torch.int32 or t.device != dev or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    # its 16-byte copies need 16-byte aligned bases (a view may start off
    # that grid)
    q, k_pool, v_pool = aligned16(q), aligned16(k_pool), aligned16(v_pool)
    nblk = table.shape[1]
    out = torch.empty_like(q)
    nch, _work, part_acc, part_ml = decode_workspace(b, h, hd, nblk * bs,
                                                     dev)
    err = build.entry("paged_attn_decode_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_acc, part_ml, b, kh, grp, hd,
        nblk, bs, int(window), nch, float(scale), dt, stream_ptr(dev))
    raise_on_error(err, "paged_attn_decode")
    return out


def mla_view_attention(q_abs: torch.Tensor, q_pe: torch.Tensor,
                       cc: torch.Tensor, cp: torch.Tensor, pos, *,
                       scale: float) -> torch.Tensor:
    """Absorbed MLA attention of one query per row against each row's
    logical view. q_abs: (B, H, r); q_pe: (B, H, dr); cc: (B, T, r); cp:
    (B, T, dr); pos: (B,) last valid position per row. Scores and the
    value product are fp32 sums, p is rounded to cc's dtype between them.
    Returns o_lat (B, H, r) in q_abs's dtype."""
    t = cc.shape[1]
    s = (torch.einsum("bhr,btr->bht", q_abs.float(), cc.float()) +
         torch.einsum("bhp,btp->bht", q_pe.float(), cp.float())) * scale
    p_b = torch.as_tensor(pos, device=cc.device).long().reshape(-1, 1, 1)
    mask = torch.arange(t, device=cc.device)[None, None, :] <= p_b
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(cc.dtype)
    return torch.einsum("bht,btr->bhr", p.float(), cc.float()).to(
        q_abs.dtype)


def mla_paged_decode_plain(q_abs: torch.Tensor, q_pe: torch.Tensor,
                           cc_pool: torch.Tensor, cp_pool: torch.Tensor,
                           table: torch.Tensor, pos: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """q_abs: (B, H, r); q_pe: (B, H, dr); cc_pool: (nblocks, bs, r);
    cp_pool: (nblocks, bs, dr); table: (B, nblk) int; pos: (B,) int.
    Returns o_lat (B, H, r) in q_abs's dtype."""
    b, nblk = table.shape
    tl = table.long().to(cc_pool.device)
    cc = cc_pool[tl].reshape(b, nblk * cc_pool.shape[1], -1)
    cp = cp_pool[tl].reshape(b, nblk * cp_pool.shape[1], -1)
    return mla_view_attention(q_abs, q_pe, cc, cp, pos, scale=scale)


def mla_paged_decode_cuda(q_abs: torch.Tensor, q_pe: torch.Tensor,
                          cc_pool: torch.Tensor, cp_pool: torch.Tensor,
                          table: torch.Tensor, pos: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """Launch the kernel that ``mla_route`` names on the current stream.
    table and pos must be contiguous int32 on the pools' device."""
    dt, dev = check_float_operands(q_abs, q_pe, cc_pool, cp_pool)
    b, h, r = q_abs.shape
    nblocks, bs, r_c = cc_pool.shape
    dr = q_pe.shape[-1]
    if q_pe.shape != (b, h, dr) or r_c != r or \
            cp_pool.shape != (nblocks, bs, dr):
        raise ValueError(f"q_abs {tuple(q_abs.shape)}, q_pe "
                         f"{tuple(q_pe.shape)} and pools "
                         f"{tuple(cc_pool.shape)} / {tuple(cp_pool.shape)} "
                         f"do not form an absorbed MLA call")
    if r % 8 or dr % 8 or r > MLA_MAX_RANK or dr > MLA_MAX_RANK:
        raise ValueError(f"the kernel takes r and dr multiples of 8 up to "
                         f"{MLA_MAX_RANK}; got r={r}, dr={dr}")
    for name, t, shape in (("table", table, (b, table.shape[-1])),
                           ("pos", pos, (b,))):
        if t.dtype != torch.int32 or t.device != dev or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    # their 16-byte copies need 16-byte aligned bases (a view may start off
    # that grid)
    q_abs, q_pe = aligned16(q_abs), aligned16(q_pe)
    cc_pool, cp_pool = aligned16(cc_pool), aligned16(cp_pool)
    nblk = table.shape[1]
    out = torch.empty_like(q_abs)
    path = mla_route(q_abs.dtype, r, dr)
    if path == "tensor_core":
        nch, _work, part_acc, part_ml = decode_workspace(
            b, h, r, nblk * bs, dev, chunk=MLA_CHUNK)
        err = build.entry("mla_paged_decode_tc_launch")(
            q_abs.data_ptr(), q_pe.data_ptr(), cc_pool.data_ptr(),
            cp_pool.data_ptr(), table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part_acc, part_ml, b, h, r, dr, nblk, bs, nch,
            float(scale), stream_ptr(dev))
    else:
        err = build.entry("mla_paged_decode_launch")(
            q_abs.data_ptr(), q_pe.data_ptr(), cc_pool.data_ptr(),
            cp_pool.data_ptr(), table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, h, r, dr, nblk, bs, float(scale), dt,
            stream_ptr(dev))
    raise_on_error(err, f"mla_paged_decode ({path})")
    MLA_ROUTE_LAUNCHES[path] += 1
    return out
