"""GQA attention, forward only: chunked (flash-style) causal attention and
single-step decode attention against a contiguous KV cache.

Port of the static-cache paths of ``repro/models/attention.py``. Written as
plain tensor code (no fused attention operator): the chunked forward keeps
the reference's online softmax over KV chunks, with the same rounding
points, and masks the keys its padding adds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, matmul

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, chunk_q: int = 1024,
                      chunk_kv: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention forward. q: (B, S, H, D); k, v: (B, T, KH, D).
    Returns (B, S, H, Dv). ``window`` 0 is full attention; ``q_offset`` is
    the absolute position of q[:, 0] (a prefill continuing a cache)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    nq = -(-s // chunk_q)
    nkv = -(-t // chunk_kv)
    pad_kv = nkv * chunk_kv - t
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    kv_pos = torch.arange(nkv * chunk_kv, dtype=torch.float32,
                          device=q.device)
    outs = []
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
        outs.append(out.transpose(1, 2).to(v.dtype))          # (B, cq, H, Dv)
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: int, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention against a cache: the S=1 case of
    `ragged_attention`. q: (B, 1, H, D); caches: (B, T, KH, D)."""
    return ragged_attention(q, k_cache, v_cache, pos=pos, window=window,
                            scale=scale)


def ragged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: int, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Multi-token attention against a cache at a scalar query offset:
    query i attends cache entries <= pos + i. q: (B, S, H, D); caches:
    (B, T, KH, D). Returns (B, S, H, Dv). (The per-slot (B,) offsets of
    the serving engine come with its slice.)"""
    b, s, h, d = q.shape
    t = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k_cache, h)
    v = _repeat_kv(v_cache, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(t, device=q.device)
    q_abs = int(pos) + torch.arange(s, device=q.device)           # (S,)
    mask = kv_pos[None, :] <= q_abs[:, None]
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_abs[:, None] - window)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(v.dtype)


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
                  kv_cache: Optional[tuple] = None,
                  cache_pos: Optional[int] = None, use_rope: bool = True):
    """Project, rope, attend, output-project. Returns (out (B,S,d), new_kv).

    - no cache: chunked attention over the block's own keys;
    - cache + scalar ``cache_pos``: K/V are written into the cache at
      [cache_pos, cache_pos + S) IN PLACE (the JAX reference returns an
      updated copy; the port updates the caller's tensors to save the
      copy), then S > 1 runs chunked attention over the cache and S == 1
      decode attention.
    """
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(x, p, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if kv_cache is not None:
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
