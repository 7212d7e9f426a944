"""Decoder blocks: the dense block (GQA attention + the dense FFN or the
converted CMoE FFN), llama4's MoE block (GQA + the pretrained MoE),
deepseek-v2's block (MLA + the pretrained MoE), the Mamba2 block and
whisper's decoder block (self-attention, cross-attention over the encoder,
the FFN). Port of ``repro/models/blocks.py``, every family.

Parameters keep the JAX layout (nested dicts, the same keys), so weights
cross between the packages unchanged (see ``repro_torch.bridge``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.attention import gqa_attention, mla_attention
from repro_torch.models.layers import ffn, lecun, matmul, rms_norm
from repro_torch.models.ssm import init_mamba2_block, mamba2_block


class BlockCtx(NamedTuple):
    positions: torch.Tensor          # rope positions: (S,) or per-slot (B, S)
    cache: Any                       # this layer's (k, v) cache slice or None
    cache_pos: Any                   # write offset into the cache: an int
    #   shared by the batch, or a per-slot (B,) tensor (the serving
    #   engine's slot-aware step: each lane reads/writes at its own depth)
    window: int                      # sliding window (0 = full)
    causal: bool
    use_rope: bool
    use_kernel: bool
    capture: bool = False            # add pre-FFN activations to aux
    phase: str = "prefill"           # "prefill" | "decode" | "mixed" (a
    #   fused serving step: backend by its true width); attention ignores it
    backend: Optional[str] = None    # routed-expert backend override
    token_valid: Optional[torch.Tensor] = None   # (B, S) bool: False =
    #   padding, which takes no routed-expert work and no load stats
    block_table: Optional[torch.Tensor] = None   # (B, nblk) int: PAGED
    #   serving; the cache leaves are a block pool (nblocks, bs, ...), lane
    #   b's logical block j is physical block_table[b, j] (0 = trash). One
    #   table serves every layer.
    row_slots: Optional[torch.Tensor] = None     # (R,) int: FUSED serving
    #   over the contiguous cache; row r is a width-1 token for lane
    #   row_slots[r] at cache_pos[r]
    row_k: Optional[torch.Tensor] = None         # (B,) int: per-row
    #   effective routed top-k (activation tiers); None = K_max everywhere
    cross_kv: Any = None             # whisper's decoder: this layer's
    #   projected encoder (k, v), or the raw encoder output (B, F, d)


def init_attn(cfg, dtype, device, generator) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {
        "wq": lecun((d, cfg.num_heads, hd), dtype, device, generator, d),
        "wk": lecun((d, cfg.num_kv_heads, hd), dtype, device, generator, d),
        "wv": lecun((d, cfg.num_kv_heads, hd), dtype, device, generator, d),
        "wo": lecun((cfg.num_heads, hd, d), dtype, device, generator,
                     cfg.num_heads * hd),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def init_mla(cfg, dtype, device, generator) -> dict:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.num_heads
    return {
        "q_dproj": lecun((d, m.q_lora_rank), dtype, device, generator, d),
        "q_norm": torch.zeros((m.q_lora_rank,), dtype=dtype, device=device),
        "q_uproj": lecun(
            (m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
            dtype, device, generator, m.q_lora_rank),
        "kv_dproj": lecun((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype,
                          device, generator, d),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dtype,
                               device=device),
        "kv_uproj": lecun(
            (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim), dtype,
            device, generator, m.kv_lora_rank),
        "wo": lecun((h, m.v_head_dim, d), dtype, device, generator,
                    h * m.v_head_dim),
    }


def init_ffn(cfg, dtype, device, generator, d_ff: Optional[int] = None
             ) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.activation in ("swiglu", "geglu"):
        return {"wg": lecun((d, d_ff), dtype, device, generator, d),
                "wu": lecun((d, d_ff), dtype, device, generator, d),
                "wd": lecun((d_ff, d), dtype, device, generator, d_ff)}
    return {"wi": lecun((d, d_ff), dtype, device, generator, d),
            "wd": lecun((d_ff, d), dtype, device, generator, d_ff)}


def init_cmoe_ffn(cfg, dtype, device, generator) -> dict:
    """Random CMoE parameters with the CONVERTED layout (a converted model
    trained or served without running the conversion)."""
    cm = cfg.cmoe
    d = cfg.d_model
    m = cfg.d_ff // cm.num_experts
    ms = cm.num_shared * m
    n_r = cm.num_routed

    def w(shape, fan_in=None):
        return lecun(shape, dtype, device, generator, fan_in)

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
    # a converted MoE model (llama4) keeps its dense layers dense
    if cfg.cmoe is not None and cfg.family in ("dense", "vlm", "audio"):
        p["cmoe"] = init_cmoe_ffn(cfg, dtype, device, generator)
    else:
        p["ffn"] = init_ffn(cfg, dtype, device, generator)
    return p


def _token_valid_flat(ctx: BlockCtx):
    """ctx.token_valid (B, S) -> (B*S, 1), matching x's token flattening."""
    if ctx.token_valid is None:
        return None
    return ctx.token_valid.reshape(-1, 1)


def _row_k_flat(x: torch.Tensor, ctx: BlockCtx):
    """ctx.row_k (B,) -> (B*S,) per-token effective k (every token of a
    row shares the row's tier)."""
    if ctx.row_k is None:
        return None
    b, s = x.shape[0], x.shape[1]
    return ctx.row_k.reshape(b, 1).expand(b, s).reshape(-1)


def _apply_ffn(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    """Dense FFN or (if converted) the CMoE sparse FFN. Returns (y, aux).
    One device: no mesh-local dispatch and no capacity policy."""
    if cfg.cmoe is not None and "cmoe" in p:
        from repro_torch.core.moe_ffn import cmoe_ffn
        return cmoe_ffn(x, p["cmoe"], cfg, use_kernel=ctx.use_kernel,
                        backend=ctx.backend, phase=ctx.phase,
                        valid=_token_valid_flat(ctx),
                        k_row=_row_k_flat(x, ctx))
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
        kv_cache=ctx.cache, cache_pos=ctx.cache_pos, use_rope=ctx.use_rope,
        block_table=ctx.block_table, row_slots=ctx.row_slots,
        use_kernel=ctx.use_kernel)
    x = x + h
    ffn_in = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _apply_ffn(ffn_in, p, cfg, ctx)
    if ctx.capture:
        aux = {**aux, "ffn_in": ffn_in}
    return x + y, new_kv, aux


# ------------------------------------------------------------ MoE

def _apply_moe(ffn_in: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    """The pretrained MoE on one device (the reference's mesh-local
    dispatch is not ported), or on a converted block (cfg.cmoe set) the
    hierarchical CMoE FFN, which takes the whole block dict. A CMoE config
    whose block holds no converted experts raises rather than serving the
    unconverted ones under a conversion tag."""
    if cfg.cmoe is not None:
        if "cmoe" not in p:
            raise ValueError(
                f"{cfg.name}: a hierarchical CMoE config on a block with "
                f"no converted experts (convert with "
                f"core.hierarchical.convert_moe_model)")
        from repro_torch.core.hierarchical import hierarchical_moe_ffn
        return hierarchical_moe_ffn(ffn_in, p, cfg, use_kernel=ctx.use_kernel,
                                    backend=ctx.backend, phase=ctx.phase,
                                    valid=_token_valid_flat(ctx),
                                    k_row=_row_k_flat(ffn_in, ctx))
    from repro_torch.models.moe import moe_ffn
    return moe_ffn(ffn_in, p["moe"], cfg, use_kernel=ctx.use_kernel,
                   backend=ctx.backend, phase=ctx.phase,
                   valid=_token_valid_flat(ctx))


def init_moe_block(cfg, dtype, device, generator) -> dict:
    """llama4's MoE layer: GQA attention and the pretrained MoE."""
    from repro_torch.models.moe import init_moe_ffn
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "attn": init_attn(cfg, dtype, device, generator),
            "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "moe": init_moe_ffn(cfg, dtype, device, generator)}


def moe_block(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    h, new_kv = gqa_attention(
        rms_norm(x, p["norm1"], cfg.norm_eps), p["attn"], cfg,
        positions=ctx.positions, causal=ctx.causal, window=ctx.window,
        kv_cache=ctx.cache, cache_pos=ctx.cache_pos,
        block_table=ctx.block_table, row_slots=ctx.row_slots,
        use_kernel=ctx.use_kernel)
    x = x + h
    ffn_in = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _apply_moe(ffn_in, p, cfg, ctx)
    if ctx.capture:
        aux = {**aux, "ffn_in": ffn_in}
    return x + y, new_kv, aux


# ------------------------------------------------------------ MLA + MoE

def init_mla_moe_block(cfg, dtype, device, generator) -> dict:
    from repro_torch.models.moe import init_moe_ffn
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "attn": init_mla(cfg, dtype, device, generator),
            "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "moe": init_moe_ffn(cfg, dtype, device, generator)}


def mla_moe_block(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    h, new_cache = mla_attention(
        rms_norm(x, p["norm1"], cfg.norm_eps), p["attn"], cfg,
        positions=ctx.positions, kv_cache=ctx.cache,
        cache_pos=ctx.cache_pos, block_table=ctx.block_table,
        row_slots=ctx.row_slots, use_kernel=ctx.use_kernel)
    x = x + h
    ffn_in = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _apply_moe(ffn_in, p, cfg, ctx)
    if ctx.capture:
        aux = {**aux, "ffn_in": ffn_in}
    return x + y, new_cache, aux


# ------------------------------------------------------------ mamba2

def init_mamba_block(cfg, dtype, device, generator) -> dict:
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mixer": init_mamba2_block(cfg, dtype, device, generator)}


def mamba_block(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    """ctx.cache is this layer's (conv_state, ssm_state), updated in
    place, or None."""
    h, new_cache = mamba2_block(rms_norm(x, p["norm1"], cfg.norm_eps),
                                p["mixer"], cfg, cache=ctx.cache,
                                use_kernel=ctx.use_kernel)
    return x + h, new_cache, {}


# ------------------------------------------------------------ whisper decoder

def init_encdec_block(cfg, dtype, device, generator) -> dict:
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
         "attn": init_attn(cfg, dtype, device, generator),
         "norm_x": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
         "xattn": init_attn(cfg, dtype, device, generator),
         "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.cmoe is not None:
        p["cmoe"] = init_cmoe_ffn(cfg, dtype, device, generator)
    else:
        p["ffn"] = init_ffn(cfg, dtype, device, generator)
    return p


def encdec_block(x: torch.Tensor, p: dict, cfg, ctx: BlockCtx):
    """Causal self-attention without RoPE (the reference hard-codes
    use_rope=False: no position signal runs in whisper's decoder), then
    cross-attention over ctx.cross_kv, then the dense or CMoE FFN."""
    h, new_kv = gqa_attention(
        rms_norm(x, p["norm1"], cfg.norm_eps), p["attn"], cfg,
        positions=ctx.positions, causal=True, kv_cache=ctx.cache,
        cache_pos=ctx.cache_pos, use_rope=False)
    x = x + h
    cross = ctx.cross_kv
    if not isinstance(cross, tuple):        # raw encoder output: project
        cross = cross_kv_project(cross, p["xattn"], cfg)
    h, _ = gqa_attention(rms_norm(x, p["norm_x"], cfg.norm_eps), p["xattn"],
                         cfg, positions=ctx.positions, cross_kv=cross)
    x = x + h
    ffn_in = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _apply_ffn(ffn_in, p, cfg, ctx)
    if ctx.capture:
        aux = {**aux, "ffn_in": ffn_in}
    return x + y, new_kv, aux


def cross_kv_project(enc_out: torch.Tensor, p_xattn: dict, cfg) -> tuple:
    """The encoder's K and V for one decoder layer's cross-attention: enc_out
    (B, F, d) -> k, v of (B, F, KH, hd)."""
    b, f, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = matmul(enc_out, p_xattn["wk"].reshape(cfg.d_model, -1)).reshape(
        b, f, cfg.num_kv_heads, hd)
    v = matmul(enc_out, p_xattn["wv"].reshape(cfg.d_model, -1)).reshape(
        b, f, cfg.num_kv_heads, hd)
    return k, v


BLOCKS = {
    "dense": (init_dense_block, dense_block),
    "moe": (init_moe_block, moe_block),
    "mla_moe": (init_mla_moe_block, mla_moe_block),
    "mamba": (init_mamba_block, mamba_block),
    "encdec": (init_encdec_block, encdec_block),
}


def block_kind(cfg) -> str:
    """The reference's block families: the hybrid's layers are Mamba2
    blocks (its shared attention block runs in the stack), and the audio
    family's are its decoder blocks (the encoder runs dense blocks)."""
    if cfg.family == "moe":
        return "mla_moe" if cfg.mla is not None else "moe"
    if cfg.family in ("ssm", "hybrid"):
        return "mamba"
    if cfg.family == "audio":
        return "encdec"
    return "dense"
