"""Attention: GQA and deepseek-v2's multi-head latent attention (MLA),
with chunked (flash-style) causal attention and its flash-style backward,
per-slot (ragged) attention against a contiguous cache, and the paged
block-pool cache of the serving engine.

Port of ``repro/models/attention.py``. Written as plain tensor code (no
fused attention operator) around the two attention kernels: the chunked
forward keeps the reference's online softmax over KV chunks, with the same
rounding points, and masks the keys its padding adds; its backward (an
autograd Function, the reference's custom VJP) recomputes score blocks
from the saved per-row lse.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import mla_view_attention
from repro_torch.models.layers import apply_rope, head_matmul, matmul, rms_norm

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, KH, D) -> (B, T, H, D) by repeating each kv head."""
    kh = k.shape[2]
    if kh == num_heads:
        return k
    return k.repeat_interleave(num_heads // kh, dim=2)


def _mask_block(qp: torch.Tensor, kp: torch.Tensor, *, causal: bool,
                window: int, t_valid: int) -> torch.Tensor:
    """(cq, ck) bool mask from float position vectors."""
    mask = kp[None, :] < float(t_valid)
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window > 0:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    return mask


def _flash_forward(q, k, v, causal: bool, window: int, q_offset: int,
                   chunk_q: int, chunk_kv: int, scale: float, t_valid: int,
                   with_lse: bool = False):
    """The blocked online-softmax forward. q: (B, S, H, D); k, v: (B, nkv *
    chunk_kv, H, D) (padded past t_valid). Returns out (B, S, H, Dv) in v's
    dtype and, with ``with_lse``, the per-row log-sum-exp (B, H, S) float32
    (1e30 where a row kept no mass), which is all the backward needs;
    None without it."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    nq = -(-s // chunk_q)
    nkv = k.shape[1] // chunk_kv
    kv_pos = torch.arange(nkv * chunk_kv, dtype=torch.float32,
                          device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        qb = q[:, qi * chunk_q:(qi + 1) * chunk_q].float()   # (B, cq, H, D)
        cq = qb.shape[1]
        qp = float(q_offset) + torch.arange(
            qi * chunk_q, qi * chunk_q + cq, dtype=torch.float32,
            device=q.device)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nkv):
            sl = slice(ki * chunk_kv, (ki + 1) * chunk_kv)
            kb, vb = k[:, sl], v[:, sl]
            s_blk = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale
            mask = _mask_block(qp, kv_pos[sl], causal=causal, window=window,
                               t_valid=t_valid)
            s_blk = torch.where(mask[None, None], s_blk,
                                torch.full_like(s_blk, NEG_INF))
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(v.dtype))          # (B, cq, H, Dv)
        if with_lse:
            lses.append(torch.where(l > 0, m + torch.log(torch.clamp(
                l, min=1e-30)), torch.full_like(l, 1e30)))
    lse = torch.cat(lses, dim=-1) if with_lse else None
    return torch.cat(outs, dim=1), lse


def _flash_backward(q, k, v, out, lse, g, causal: bool, window: int,
                    q_offset: int, chunk_q: int, chunk_kv: int, scale: float,
                    t_valid: int):
    """The flash-style backward: score blocks recomputed from q, k and the
    saved lse, never the (S, T) probabilities. Pass 1 accumulates dq over
    kv blocks, pass 2 dk and dv over q blocks, both in float32 with delta =
    rowsum(g * out); the results are cast to the inputs' dtypes."""
    b, s, h, d = q.shape
    nq = -(-s // chunk_q)
    nkv = k.shape[1] // chunk_kv
    kv_pos = torch.arange(nkv * chunk_kv, dtype=torch.float32,
                          device=q.device)
    q_pos = float(q_offset) + torch.arange(s, dtype=torch.float32,
                                           device=q.device)
    gf = g.float()
    delta = torch.einsum("bqhd,bqhd->bhq", gf, out.float())   # (B, H, S)
    qsl = [slice(i * chunk_q, (i + 1) * chunk_q) for i in range(nq)]
    ksl = [slice(i * chunk_kv, (i + 1) * chunk_kv) for i in range(nkv)]

    def p_block(qs, ks):
        s_blk = torch.einsum("bqhd,bkhd->bhqk", q[:, qs].float(),
                             k[:, ks].float()) * scale
        mask = _mask_block(q_pos[qs], kv_pos[ks], causal=causal,
                           window=window, t_valid=t_valid)
        s_blk = torch.where(mask[None, None], s_blk,
                            torch.full_like(s_blk, NEG_INF))
        return torch.exp(s_blk - lse[:, :, qs, None])           # (B,H,cq,ck)

    def ds_block(p, qs, ks):
        dp = torch.einsum("bqhd,bkhd->bhqk", gf[:, qs], v[:, ks].float())
        return p * (dp - delta[:, :, qs, None])

    dq = []
    for qs in qsl:                       # pass 1: dq over the kv blocks
        acc = torch.zeros_like(q[:, qs], dtype=torch.float32)
        for ks in ksl:
            ds = ds_block(p_block(qs, ks), qs, ks)
            acc = acc + torch.einsum("bhqk,bkhd->bqhd", ds,
                                     k[:, ks].float()) * scale
        dq.append(acc)
    dk, dv = [], []
    for ks in ksl:                       # pass 2: dk, dv over the q blocks
        acc_k = torch.zeros_like(k[:, ks], dtype=torch.float32)
        acc_v = torch.zeros_like(v[:, ks], dtype=torch.float32)
        for qs in qsl:
            p = p_block(qs, ks)
            acc_v = acc_v + torch.einsum("bhqk,bqhd->bkhd", p, gf[:, qs])
            ds = ds_block(p, qs, ks)
            acc_k = acc_k + torch.einsum("bhqk,bqhd->bkhd", ds,
                                         q[:, qs].float()) * scale
        dk.append(acc_k)
        dv.append(acc_v)
    return (torch.cat(dq, dim=1).to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Blocked attention with a flash-style forward and backward (the
    reference's ``_flash`` custom VJP): the forward saves q, k, v, out and
    the per-row lse; the backward recomputes score blocks. window and
    q_offset take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, chunk_q, chunk_kv,
                scale, t_valid):
        out, lse = _flash_forward(q, k, v, causal, window, q_offset,
                                  chunk_q, chunk_kv, scale, t_valid,
                                  with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, chunk_q, chunk_kv, scale,
                    t_valid)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g, *ctx.args)
        return (dq, dk, dv) + (None,) * 7


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, chunk_q: int = 1024,
                      chunk_kv: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention, forward and backward. q: (B, S, H, D); k, v:
    (B, T, KH, D). Returns (B, S, H, Dv). ``window`` 0 is full attention;
    ``q_offset`` is the absolute position of q[:, 0] (a prefill continuing
    a cache). The GQA repeat and the kv padding stay outside the autograd
    Function, so autograd sums dk and dv over repeated heads. Only a call
    that autograd records goes through the Function and builds the lse
    (the reference's custom-VJP forward); any other runs the plain forward
    (its primal), with the same output."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    nkv = -(-t // chunk_kv)
    pad_kv = nkv * chunk_kv - t
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    args = (causal, int(window), int(q_offset), chunk_q, chunk_kv, scale, t)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, *args)
    return _flash_forward(q, k, v, *args)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention against a cache: the S=1 case of
    `ragged_attention`. q: (B, 1, H, D); caches: (B, T, KH, D); pos: a
    scalar or per-slot (B,) current position."""
    return ragged_attention(q, k_cache, v_cache, pos=pos, window=window,
                            scale=scale)


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position -> a (B,) int64 tensor on `device`."""
    p = torch.as_tensor(pos, device=device).long().reshape(-1)
    return p.expand(b) if p.numel() == 1 else p


def ragged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Multi-token attention against a cache with per-slot query offsets:
    query i of lane b attends cache entries <= pos[b] + i. q: (B, S, H,
    D); caches: (B, T, KH, D); pos: (B,) or a scalar shared by the batch.
    Returns (B, S, H, Dv)."""
    b, s, h, d = q.shape
    t = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k_cache, h)
    v = _repeat_kv(v_cache, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(t, device=q.device)
    q_abs = _pos_vector(pos, b, q.device)[:, None] + \
        torch.arange(s, device=q.device)                      # (B, S)
    mask = kv_pos[None, None, None, :] <= q_abs[:, None, :, None]
    if window > 0:
        mask = mask & (kv_pos[None, None, None, :] >
                       q_abs[:, None, :, None] - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(v.dtype)


def is_per_slot(pos) -> bool:
    """True when a cache position is a per-slot (B,) vector rather than a
    scalar shared by the whole batch."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


# ------------------------------------------------------------ paged cache
#
# The JAX reference returns updated copies of the cache; the port writes
# into the caller's pool or cache in place (no per-step copy of the
# cache). Every write lands on the current stream before the attention that
# reads it, so a row sees its own and its siblings' new keys exactly as the
# reference's write-then-view does.

def paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each lane's logical sequence view from a block pool. pool:
    (nblocks, bs, ...); table: (B, nblk), physical block 0 the trash block.
    Returns (B, nblk * bs, ...)."""
    b, nblk = table.shape
    g = pool[table.long()]                          # (B, nblk, bs, ...)
    return g.reshape(b, nblk * pool.shape[1], *pool.shape[2:])


def paged_cache_update(pool: torch.Tensor, vals: torch.Tensor, pos,
                       table: torch.Tensor) -> torch.Tensor:
    """Write vals (B, S, ...) into a block pool in place: token i of lane
    b lands at logical position p = pos[b] + i, physical (table[b, p //
    bs], p % bs). Writes past the table width (a padded chunk tail
    spilling beyond the lane's allocation) go to the trash block 0, as do
    writes through unallocated entries (which hold 0). Trash contents are
    finite garbage no mask reaches. Returns the pool."""
    bs = pool.shape[1]
    b, s = vals.shape[0], vals.shape[1]
    nblk = table.shape[1]
    p = _pos_vector(pos, b, pool.device)[:, None] + \
        torch.arange(s, device=pool.device)
    blk, off = p // bs, p % bs                      # (B, S) each
    tl = table.long().to(pool.device)
    phys = torch.gather(tl, 1, blk.clamp(0, nblk - 1))
    phys = torch.where(blk < nblk, phys, torch.zeros_like(phys))
    pool[phys, off] = vals.to(pool.dtype)
    return pool


def paged_ragged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, *, table: torch.Tensor,
                           pos, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """`ragged_attention` over a paged cache: index the pool by block
    table into the logical (B, T) view, then the shared per-slot masks."""
    k = paged_view(k_pool, table)
    v = paged_view(v_pool, table)
    return ragged_attention(q, k, v, pos=pos, window=window, scale=scale)


def rows_attention(q: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, *, table: torch.Tensor, pos,
                   window: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Per-slot attention through the ``paged_attn_decode`` kernel, one
    kernel row per query token: query i of lane b becomes a row at
    position pos[b] + i reading lane b's table. q: (B, S, H, D); table:
    (B, nblk). Returns (B, S, H, D).

    The kernel's arithmetic for a row depends only on its query, its keys
    and its position, never on how many rows ride the call nor on the
    pool's block size. So a prefill chunk, a decode step, a fused step's
    row, a paged lane and a contiguous lane (a pool of one block per lane)
    all give a token bitwise the same attention output: this is what keeps
    the serving engine's parity gates exact on the card."""
    from repro_torch.kernels import ops as kops
    b, s, h, d = q.shape
    sc = scale if scale is not None else d ** -0.5
    rows_pos = (_pos_vector(pos, b, q.device)[:, None] +
                torch.arange(s, device=q.device)).reshape(-1)
    tl = table if s == 1 else \
        table[:, None].expand(b, s, table.shape[1]).reshape(b * s, -1)
    out = kops.paged_attn_decode(q.reshape(b * s, 1, h, d), k_pool, v_pool,
                                 table=tl, pos=rows_pos, window=window,
                                 scale=sc)
    return out.reshape(b, s, h, d)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, *, table: torch.Tensor,
                           pos, window: int = 0,
                           scale: Optional[float] = None,
                           use_kernel: bool = False) -> torch.Tensor:
    """The S=1 case of `paged_ragged_attention`. With ``use_kernel`` the
    ``paged_attn_decode`` kernel attends the pool directly (only live
    blocks are read, no logical view is materialized)."""
    if use_kernel:
        return rows_attention(q, k_pool, v_pool, table=table, pos=pos,
                              window=window, scale=scale)
    return paged_ragged_attention(q, k_pool, v_pool, table=table, pos=pos,
                                  window=window, scale=scale)


def slot_cache_update(cache: torch.Tensor, vals: torch.Tensor, pos
                      ) -> torch.Tensor:
    """Write vals (B, S, ...) into cache (B, T, ...) in place at per-slot
    offsets: row b lands at cache[b, pos[b] : pos[b] + S]. Writes past T
    are dropped (a padded prefill row may spill past max_len; those
    entries are never attended). Without a host read of pos, the drop is
    done one column at a time: column i's rows hit distinct lanes, and a
    spilled entry rewrites its lane's last cell with the value that cell
    already holds. Returns the cache."""
    b, s = vals.shape[0], vals.shape[1]
    t = cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    p = _pos_vector(pos, b, cache.device)
    vals = vals.to(cache.dtype)
    for i in range(s):
        col = p + i
        ok = (col < t).reshape(b, *([1] * (vals.dim() - 2)))
        colc = col.clamp(max=t - 1)
        cache[rows, colc] = torch.where(ok, vals[:, i], cache[rows, colc])
    return cache


def _lane_table(n: int, device) -> torch.Tensor:
    """(n, 1) table reading lane i of a contiguous (n, T, ...) cache as
    block i of a pool of one block per lane."""
    return torch.arange(n, device=device, dtype=torch.int32)[:, None]


# ------------------------------------------------------------------ GQA

def gqa_project_qkv(x: torch.Tensor, p: dict, cfg):
    """x: (B, S, d) -> q (B,S,H,hd), k, v (B,S,KH,hd), biases added."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = matmul(x, p["wq"].reshape(cfg.d_model, -1)).reshape(
        b, s, cfg.num_heads, hd)
    k = matmul(x, p["wk"].reshape(cfg.d_model, -1)).reshape(
        b, s, cfg.num_kv_heads, hd)
    v = matmul(x, p["wv"].reshape(cfg.d_model, -1)).reshape(
        b, s, cfg.num_kv_heads, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def gqa_attention(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  kv_cache: Optional[tuple] = None, cache_pos=None,
                  cross_kv: Optional[tuple] = None,
                  use_rope: bool = True,
                  block_table: Optional[torch.Tensor] = None,
                  row_slots: Optional[torch.Tensor] = None,
                  use_kernel: bool = False):
    """Project, rope, attend, output-project. Returns (out (B,S,d), new_kv).

    K/V are written into the cache IN PLACE (the JAX reference returns an
    updated copy; the port updates the caller's tensors to save the copy):

    - ``cross_kv`` (k, v) of (B, F, KH, hd): whisper's cross-attention
      over the encoder's projected frames. Only q is projected, with no
      RoPE; every frame is visible (non-causal chunked attention for S > 1,
      decode attention at pos F - 1 for S == 1); no cache is written and
      new_kv is None;
    - no cache: chunked attention over the block's own keys;
    - ``block_table`` (B, nblk): the cache leaves are a PAGED pool
      (nblocks, bs, KH, hd); writes go through the table, reads assemble
      each lane's logical view (or, with ``use_kernel``, the
      ``paged_attn_decode`` kernel reads the pool directly);
    - ``row_slots`` (R,): a FUSED step over the contiguous global cache
      (S must be 1); row r writes at (row_slots[r], cache_pos[r]), all rows
      write before any row attends its lane's updated view;
    - per-slot (B,) ``cache_pos``: each lane writes and attends at its own
      depth;
    - scalar ``cache_pos``: the static path, chunked attention for S > 1
      and decode attention for S == 1.

    With ``use_kernel``, every per-slot path (paged or contiguous, chunk
    or decode or fused row) attends through the kernel, one row per query
    token (see `rows_attention`), so a token's attention is the same
    arithmetic on every path.
    """
    b, s, _ = x.shape
    if cross_kv is not None:
        q = matmul(x, p["wq"].reshape(cfg.d_model, -1)).reshape(
            b, s, cfg.num_heads, cfg.resolved_head_dim)
        k, v = cross_kv
        out = chunked_attention(q, k, v, causal=False) if s > 1 else \
            decode_attention(q, k, v, pos=k.shape[1] - 1)
        out = matmul(out.reshape(b, s, -1), p["wo"].reshape(-1, cfg.d_model))
        return out, None
    q, k, v = gqa_project_qkv(x, p, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if kv_cache is not None and (block_table is not None or
                                 row_slots is not None or
                                 is_per_slot(cache_pos)):
        ck, cv = kv_cache
        start = cache_pos
        if block_table is not None:
            paged_cache_update(ck, k, start, block_table)
            paged_cache_update(cv, v, start, block_table)
            if s == 1:
                out = paged_decode_attention(q, ck, cv, table=block_table,
                                             pos=start, window=window,
                                             use_kernel=use_kernel)
            elif use_kernel:
                out = rows_attention(q, ck, cv, table=block_table, pos=start,
                                     window=window)
            else:
                out = paged_ragged_attention(q, ck, cv, table=block_table,
                                             pos=start, window=window)
        elif row_slots is not None:
            # fused step: every row is a width-1 token for GLOBAL lane
            # row_slots[r] at position start[r]. All rows write first
            # (distinct cells; padding rows rewrite row 0's cell with row
            # 0's value), then each row attends its lane's updated view:
            # earlier siblings are present, later ones sit past start[r]
            # where the mask never looks
            rs = row_slots.long()
            pcols = _pos_vector(start, b, ck.device)
            ck[rs, pcols] = k[:, 0].to(ck.dtype)
            cv[rs, pcols] = v[:, 0].to(cv.dtype)
            if use_kernel:
                out = rows_attention(q, ck, cv, table=row_slots.to(
                    torch.int32)[:, None], pos=start, window=window)
            else:
                out = decode_attention(q, ck[rs], cv[rs], pos=start,
                                       window=window)
        else:
            slot_cache_update(ck, k, start)
            slot_cache_update(cv, v, start)
            if use_kernel:
                out = rows_attention(q, ck, cv,
                                     table=_lane_table(b, ck.device),
                                     pos=start, window=window)
            else:
                out = ragged_attention(q, ck, cv, pos=start, window=window)
        new_kv = (ck, cv)
    elif kv_cache is not None:
        ck, cv = kv_cache
        start = int(cache_pos) if cache_pos is not None else 0
        if start < 0 or start + s > ck.shape[1]:
            raise ValueError(f"cache write [{start}, {start + s}) outside "
                             f"a cache of length {ck.shape[1]}")
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        new_kv = (ck, cv)
        if s == 1:
            out = decode_attention(q, ck, cv, pos=start, window=window)
        else:
            out = chunked_attention(q, ck, cv, causal=causal, window=window,
                                    q_offset=start)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    out = matmul(out.reshape(b, s, -1), p["wo"].reshape(-1, cfg.d_model))
    return out, new_kv


# ------------------------------------------------------------------ MLA

def mla_rows_attention(q_abs: torch.Tensor, q_pe: torch.Tensor,
                       cc_pool: torch.Tensor, cp_pool: torch.Tensor, *,
                       table: torch.Tensor, pos,
                       scale: float) -> torch.Tensor:
    """Per-slot absorbed MLA attention through the ``mla_paged_decode``
    kernel, one kernel row per query token: query i of lane b becomes a
    row at position pos[b] + i reading lane b's table. q_abs: (B, S, H,
    r); q_pe: (B, S, H, dr); table: (B, nblk). Returns o_lat (B, S, H, r).
    As `rows_attention` does for GQA, this gives a token bitwise the same
    output on every per-slot path (chunk, decode, fused row; paged or
    contiguous lane)."""
    from repro_torch.kernels import ops as kops
    b, s, h, r = q_abs.shape
    rows_pos = (_pos_vector(pos, b, q_abs.device)[:, None] +
                torch.arange(s, device=q_abs.device)).reshape(-1)
    tl = table if s == 1 else \
        table[:, None].expand(b, s, table.shape[1]).reshape(b * s, -1)
    out = kops.mla_paged_decode(
        q_abs.reshape(b * s, h, r), q_pe.reshape(b * s, h, -1), cc_pool,
        cp_pool, table=tl, pos=rows_pos, scale=scale)
    return out.reshape(b, s, h, r)


def _expand_kv(cc: torch.Tensor, cp: torch.Tensor, wkv: torch.Tensor, *,
               dn: int, dtype) -> tuple:
    """Per-head keys and values from latents: cc (B, T, r), cp (B, T, dr),
    wkv (r, H, dn + dv) -> k (B, T, H, dn + dr), v (B, T, H, dv) in
    `dtype` (fp32 sums rounded once)."""
    b, t, r = cc.shape
    h = wkv.shape[1]
    kv = matmul(cc, wkv.reshape(r, -1)).reshape(b, t, h, -1).to(dtype)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, cp[:, :, None, :].expand(
        b, t, h, cp.shape[-1]).to(dtype)], dim=-1)
    return k, v


def mla_attention(x: torch.Tensor, p: dict, cfg, *,
                  positions: torch.Tensor,
                  kv_cache: Optional[tuple] = None, cache_pos=None,
                  block_table: Optional[torch.Tensor] = None,
                  row_slots: Optional[torch.Tensor] = None,
                  use_kernel: bool = False):
    """DeepSeek-v2 multi-head latent attention. Returns (out (B,S,d),
    new_cache).

    The cache holds the compressed latent c_kv (.., T, r) and the rope key
    (.., T, dr), written IN PLACE (the JAX reference returns updated
    copies). Decode runs the ABSORBED form: q_nope goes through W_uk so
    scores contract against the latent, and the softmax-weighted latent is
    expanded through W_uv. The cache branches follow ``gqa_attention``:

    - no cache: per-head K/V expanded from the latents, chunked attention;
    - scalar ``cache_pos`` (the static path): a prefill runs the flash
      loop that expands K/V per KV chunk (`_mla_flash_prefill`), a decode
      step the absorbed form against the contiguous cache;
    - ``block_table`` (paged pools (nblocks, bs, r) / (nblocks, bs, dr)),
      ``row_slots`` (a fused step over the contiguous global cache: all
      rows write before any attends) and per-slot ``cache_pos``: a decode
      step runs the absorbed form over each row's view, a prefill chunk
      the expanded K/V with per-slot masks, as the reference does.

    With ``use_kernel``, every per-slot path (paged or contiguous, chunk or
    decode or fused row) attends in the absorbed form through the
    ``mla_paged_decode`` kernel, one row per query token (see
    `mla_rows_attention`): a token's attention is then the same arithmetic
    on every path, which keeps the engine's parity gates exact on the
    card. It agrees with the reference's expanded prefill within float
    tolerance."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    scale = (dn + dr) ** -0.5

    # queries through the low-rank projection
    cq = rms_norm(matmul(x, p["q_dproj"]), p["q_norm"], 1e-5)
    q = matmul(cq, p["q_uproj"].reshape(m.q_lora_rank, -1)).reshape(
        b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    # the compressed KV and the shared rope key
    ckv = matmul(x, p["kv_dproj"])
    c_kv = rms_norm(ckv[..., :r], p["kv_norm"], 1e-5)
    k_pe = apply_rope(ckv[..., None, r:], positions, cfg.rope_theta)
    k_pe = k_pe[..., 0, :]                               # one shared head
    wkv = p["kv_uproj"].reshape(r, h, dn + dv)
    wk, wv = wkv[..., :dn], wkv[..., dn:]

    def absorb(qn):                      # (B, S, H, dn) -> (B, S, H, r)
        return head_matmul(qn.reshape(b * s, h, dn),
                           wk.permute(1, 2, 0)).reshape(b, s, h, r)

    def expand(o_lat):                   # (B, S, H, r) -> (B, S, H, dv)
        return head_matmul(o_lat.reshape(b * s, h, r).to(x.dtype),
                           wv.permute(1, 0, 2)).reshape(b, s, h, dv)

    def absorbed(cc, cp, pos):
        """One query per row against row views cc (B, T, r), cp (B, T,
        dr), masked at pos."""
        o_lat = mla_view_attention(absorb(q_nope)[:, 0].to(cc.dtype),
                                   q_pe[:, 0].to(cc.dtype), cc, cp, pos,
                                   scale=scale)
        return expand(o_lat[:, None])

    def expanded_ragged(cc, cp, pos):
        k, v = _expand_kv(cc, cp, wkv, dn=dn, dtype=x.dtype)
        return ragged_attention(torch.cat([q_nope, q_pe], dim=-1), k, v,
                                pos=pos, scale=scale)

    new_cache = None
    if kv_cache is not None and (block_table is not None or
                                 row_slots is not None or
                                 is_per_slot(cache_pos)):
        cc, cp = kv_cache
        start = cache_pos
        if block_table is not None:
            paged_cache_update(cc, c_kv, start, block_table)
            paged_cache_update(cp, k_pe, start, block_table)
            table = block_table

            def view():
                return paged_view(cc, table), paged_view(cp, table)
        elif row_slots is not None:
            # fused step: all rows write first (distinct cells; padding
            # rows rewrite row 0's cell with row 0's value), then each row
            # attends its lane's updated view, whose mask (<= start[r])
            # keeps same-step siblings causal
            rs = row_slots.long()
            pcols = _pos_vector(start, b, cc.device)
            cc[rs, pcols] = c_kv[:, 0].to(cc.dtype)
            cp[rs, pcols] = k_pe[:, 0].to(cp.dtype)
            table = row_slots.to(torch.int32)[:, None]

            def view():
                return cc[rs], cp[rs]
        else:
            slot_cache_update(cc, c_kv, start)
            slot_cache_update(cp, k_pe, start)
            table = _lane_table(b, cc.device)

            def view():
                return cc, cp
        new_cache = (cc, cp)
        if use_kernel:
            o_lat = mla_rows_attention(absorb(q_nope).to(cc.dtype),
                                       q_pe.to(cc.dtype), cc, cp,
                                       table=table, pos=start, scale=scale)
            out = expand(o_lat)
        elif s == 1:
            out = absorbed(*view(), _pos_vector(start, b, cc.device))
        else:
            out = expanded_ragged(*view(), start)
    elif kv_cache is not None:
        cc, cp = kv_cache
        start = int(cache_pos) if cache_pos is not None else 0
        if start < 0 or start + s > cc.shape[1]:
            raise ValueError(f"cache write [{start}, {start + s}) outside "
                             f"a cache of length {cc.shape[1]}")
        cc[:, start:start + s] = c_kv.to(cc.dtype)
        cp[:, start:start + s] = k_pe.to(cp.dtype)
        new_cache = (cc, cp)
        if s == 1:
            out = absorbed(cc, cp, _pos_vector(start, b, cc.device))
        else:
            out = _mla_flash_prefill(torch.cat([q_nope, q_pe], dim=-1), cc,
                                     cp, wk, wv, scale=scale, q_offset=start,
                                     dn=dn)
    else:
        k, v = _expand_kv(c_kv, k_pe, wkv, dn=dn, dtype=x.dtype)
        out = chunked_attention(torch.cat([q_nope, q_pe], dim=-1), k, v,
                                causal=True, scale=scale)
    out = matmul(out.reshape(b, s, h * dv), p["wo"].reshape(h * dv, -1))
    return out, new_cache


def _mla_flash_prefill(q: torch.Tensor, cc: torch.Tensor, cp: torch.Tensor,
                       wk: torch.Tensor, wv: torch.Tensor, *, scale: float,
                       q_offset: int, dn: int, chunk_q: int = 1024,
                       chunk_kv: int = 1024) -> torch.Tensor:
    """Flash attention over the MLA latent: per-head K/V are expanded from
    the latent one KV chunk at a time inside the loop, so the (T, H,
    dn + dv) expansion never exists whole. q: (B, S, H, dn + dr) rope'd
    queries; cc: (B, T, r); cp: (B, T, dr); wk: (r, H, dn); wv: (r, H,
    dv). Returns (B, S, H, dv) in cc's dtype."""
    b, s, h, dq = q.shape
    t, r = cc.shape[1], cc.shape[2]
    dr = dq - dn
    dv = wv.shape[-1]
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    nq = -(-s // chunk_q)
    nkv = -(-t // chunk_kv)
    pad_kv = nkv * chunk_kv - t
    if pad_kv:
        cc = torch.nn.functional.pad(cc, (0, 0, 0, pad_kv))
        cp = torch.nn.functional.pad(cp, (0, 0, 0, pad_kv))
    kv_pos = torch.arange(nkv * chunk_kv, dtype=torch.float32,
                          device=q.device)
    wk2 = wk.reshape(r, h * dn)
    wv2 = wv.reshape(r, h * dv)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        cq = qb.shape[1]
        qp = float(q_offset) + torch.arange(
            qi * chunk_q, qi * chunk_q + cq, dtype=torch.float32,
            device=q.device)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nkv):
            sl = slice(ki * chunk_kv, (ki + 1) * chunk_kv)
            ccb, cpb = cc[:, sl], cp[:, sl]
            ck = ccb.shape[1]
            # expand this chunk's K/V from the latent
            kb = matmul(ccb, wk2).reshape(b, ck, h, dn).to(qb.dtype)
            vb = matmul(ccb, wv2).reshape(b, ck, h, dv).to(qb.dtype)
            kfull = torch.cat([kb, cpb[:, :, None, :].expand(
                b, ck, h, dr).to(qb.dtype)], dim=-1)
            s_blk = torch.einsum("bqhd,bkhd->bhqk", qb.float(),
                                 kfull.float()) * scale
            mask = _mask_block(qp, kv_pos[sl], causal=True, window=0,
                               t_valid=t)
            s_blk = torch.where(mask[None, None], s_blk,
                                torch.full_like(s_blk, NEG_INF))
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1).to(cc.dtype)
