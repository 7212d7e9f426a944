"""Dense decoder block: GQA attention + the dense FFN or the converted CMoE
FFN. Port of the dense family of ``repro/models/blocks.py``.

Parameters keep the JAX layout (nested dicts, the same keys), so weights
cross between the packages unchanged (see ``repro_torch.bridge``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import ffn, rms_norm


class BlockCtx(NamedTuple):
    positions: torch.Tensor          # rope positions: (S,)
    cache: Any                       # this layer's (k, v) cache slice or None
    cache_pos: Optional[int]         # scalar write offset into the cache
    window: int                      # sliding window (0 = full)
    causal: bool
    use_rope: bool
    use_kernel: bool
    capture: bool = False            # add pre-FFN activations to aux
    phase: str = "prefill"           # "prefill" | "decode": expert backend
    backend: Optional[str] = None    # routed-expert backend override


def _lecun(shape, dtype, device, generator, fan_in=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / fan_in) ** 0.5).to(dtype)


def init_attn(cfg, dtype, device, generator) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {
        "wq": _lecun((d, cfg.num_heads, hd), dtype, device, generator, d),
        "wk": _lecun((d, cfg.num_kv_heads, hd), dtype, device, generator, d),
        "wv": _lecun((d, cfg.num_kv_heads, hd), dtype, device, generator, d),
        "wo": _lecun((cfg.num_heads, hd, d), dtype, device, generator,
                     cfg.num_heads * hd),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def init_ffn(cfg, dtype, device, generator, d_ff: Optional[int] = None
             ) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.activation in ("swiglu", "geglu"):
        return {"wg": _lecun((d, d_ff), dtype, device, generator, d),
                "wu": _lecun((d, d_ff), dtype, device, generator, d),
                "wd": _lecun((d_ff, d), dtype, device, generator, d_ff)}
    return {"wi": _lecun((d, d_ff), dtype, device, generator, d),
            "wd": _lecun((d_ff, d), dtype, device, generator, d_ff)}


def init_cmoe_ffn(cfg, dtype, device, generator) -> dict:
    """Random CMoE parameters with the CONVERTED layout (a converted model
    trained or served without running the conversion)."""
    cm = cfg.cmoe
    d = cfg.d_model
    m = cfg.d_ff // cm.num_experts
    ms = cm.num_shared * m
    n_r = cm.num_routed

    def w(shape, fan_in=None):
        return _lecun(shape, dtype, device, generator, fan_in)

    if cfg.activation in ("swiglu", "geglu"):
        shared = {"wg": w((d, ms)), "wu": w((d, ms)), "wd": w((ms, d), ms)}
        routed = {"wg": w((n_r, d, m), d), "wu": w((n_r, d, m), d),
                  "wd": w((n_r, m, d), m)}
        router = {"wg_r": w((d, n_r)), "wu_r": w((d, n_r))}
    else:
        shared = {"wi": w((d, ms)), "wd": w((ms, d), ms)}
        routed = {"wi": w((n_r, d, m), d), "wd": w((n_r, m, d), m)}
        router = {"wi_r": w((d, n_r))}
    zeros = torch.zeros((n_r,), dtype=torch.float32, device=device)
    return {"shared": shared, "routed": routed, "router": router,
            "u": zeros, "bias": zeros.clone()}


def init_dense_block(cfg, dtype, device, generator) -> dict:
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
         "attn": init_attn(cfg, dtype, device, generator),
         "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.cmoe is not None:
        p["cmoe"] = init_cmoe_ffn(cfg, dtype, device, generator)
    else:
        p["ffn"] = init_ffn(cfg, dtype, device, generator)
    return p


def _apply_ffn(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    """Dense FFN or (if converted) the CMoE sparse FFN. Returns (y, aux).
    One device: no mesh-local dispatch and no capacity policy."""
    if cfg.cmoe is not None and "cmoe" in p:
        from repro_torch.core.moe_ffn import cmoe_ffn
        return cmoe_ffn(x, p["cmoe"], cfg, use_kernel=ctx.use_kernel,
                        backend=ctx.backend, phase=ctx.phase)
    if ctx.use_kernel and cfg.activation in ("swiglu", "geglu"):
        from repro_torch.kernels import ops as kops
        y = kops.swiglu_ffn(x, p["ffn"]["wg"], p["ffn"]["wu"],
                            p["ffn"]["wd"], activation=cfg.activation)
        return y, {}
    return ffn(x, p["ffn"], cfg.activation), {}


def dense_block(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    h, new_kv = gqa_attention(
        rms_norm(x, p["norm1"], cfg.norm_eps), p["attn"], cfg,
        positions=ctx.positions, causal=ctx.causal, window=ctx.window,
        kv_cache=ctx.cache, cache_pos=ctx.cache_pos, use_rope=ctx.use_rope)
    x = x + h
    ffn_in = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _apply_ffn(ffn_in, p, cfg, ctx)
    if ctx.capture:
        aux = {**aux, "ffn_in": ffn_in}
    return x + y, new_kv, aux
