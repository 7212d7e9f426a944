"""Model facade for the dense decoder family, the VLM family (dense blocks
behind a prefix of patch embeddings, internvl2), llama4 (dense and GQA +
MoE layers interleaved, the MoE pretrained or hierarchically converted),
deepseek-v2 (MLA + the pretrained MoE, or its hierarchical CMoE
conversion), Mamba2 (SSM), the zamba2 hybrid and whisper's encoder-decoder
(the audio family).

Port of every family's path of ``repro/models/model.py``. Parameters are nested dicts of tensors in the
JAX layout: block leaves are stacked over layers as (L, ...) (llama4: a
``blocks_dense`` and a ``blocks_moe`` stack of L/2 layers each), and the
reference's ``lax.scan`` over that stack becomes a Python loop over
layers. Caches are (k, v) tuples of (L, B, T, KH, hd) tensors, or paged
pools of (L, nblocks, bs, KH, hd), and for MLA (latent, rope key) tuples of
(L, B, T, r) / (L, B, T, dr), or pools of (L, nblocks, bs, r) / (L,
nblocks, bs, dr); for Mamba2 (conv state, SSM state) tuples of (L, B,
cw-1, di+2N) / (L, B, nh, hp, N), and for the hybrid that pair followed by
the shared attention block's k and v of (n_apps, B, T, KH, hd). llama4's
cache is the flat (k, v) pair of L layers in model order, where the
reference nests ((k_dense, v_dense), (k_moe, v_moe)) of L/2 each: period
i's dense layer is layer 2i, its MoE layer 2i + 1. The audio family's cache
is the reference's {"self": (k, v) of (L, B, T, KH, hd), "cross": (k, v)
of (L, B, F, KH, hd)}, the decoder's own keys and each layer's projection
of the encoder's F frames. ``step`` updates every cache in place; the
audio family is served by ``prefill`` and ``decode_step`` only, as in the
reference. ``loss`` is the training objective (the sequence-chunked
cross-entropy, each layer under activation checkpointing when ``remat``),
differentiated by autograd on a model whose kernels are off.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.blocks import BlockCtx, block_kind
from repro_torch.models.layers import embed, matmul, rms_norm, unembed
from repro_torch.models.ssm import d_inner, num_ssm_heads

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def tree_map(fn, tree, *rest):
    """Apply fn to every tensor leaf of a nested dict/tuple/list (and the
    matching leaves of ``rest``, trees of the same structure). None is an
    empty subtree, as in JAX: it maps to None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest)


def tree_stack(trees: list):
    """Stack a list of same-structured nested dicts leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stack_into(stacked, tree, i: int) -> None:
    """stacked[...][i] = tree leaf by leaf (same nested-dict structure)."""
    if isinstance(stacked, dict):
        for k in stacked:
            _stack_into(stacked[k], tree[k], i)
    else:
        stacked[i] = tree


def init_stacked(make, n: int):
    """Stack n draws of ``make()`` (a nested dict of tensors) leaf by leaf
    into (n, ...) tensors, drawing and copying in one layer at a time: the
    peak is the stack plus one layer, not two copies of the stack. A single
    draw gets its leading axis as a view, with no copy."""
    first = make()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), first)
    stacked = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    _stack_into(stacked, first, 0)
    del first
    for i in range(1, n):
        _stack_into(stacked, make(), i)
    return stacked


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding window (0 = full). gemma3: every (r+1)-th layer is
    global, the others take ``cfg.sliding_window``."""
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        return [0 if (i + 1) % (r + 1) == 0 else cfg.sliding_window
                for i in range(cfg.num_layers)]
    return [cfg.sliding_window] * cfg.num_layers


def hybrid_attn_layers(cfg: ModelConfig) -> tuple[list, list, int]:
    """(is_attn (L,), app_idx (L,), num_apps) for zamba2-style stacks: the
    shared attention block runs after every ``hybrid_attn_every``-th layer,
    application i with KV cache slice i."""
    k = cfg.hybrid_attn_every
    is_attn = [(i + 1) % k == 0 for i in range(cfg.num_layers)]
    app_idx, n = [], 0
    for flag in is_attn:
        n += flag
        app_idx.append(n - 1)
    return is_attn, app_idx, n


def tree_leaves(tree) -> list:
    """The tensor leaves in one fixed order (dicts in insertion order);
    None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class Model:
    """Functional model: params and caches are passed in, as in the JAX
    reference. ``device`` defaults to ``cuda`` and raises without a GPU;
    ``use_kernel`` defaults to on exactly when the device is CUDA."""

    def __init__(self, cfg: ModelConfig, use_kernel: Optional[bool] = None,
                 backend: Optional[str] = None, device=None):
        self.kind = block_kind(cfg)
        moe_every = cfg.moe.moe_every if cfg.moe is not None else 1
        dense = cfg.family in ("dense", "vlm") and cfg.moe is None and \
            cfg.mla is None
        routed = self.kind in ("moe", "mla_moe") and moe_every == 1
        # llama4: dense and MoE layers interleaved (the reference's
        # _stack_interleaved, a scan over periods of one of each)
        self.interleaved = self.kind == "moe" and moe_every > 1
        mamba = cfg.cmoe is None and (cfg.family == "ssm" or (
            cfg.family == "hybrid" and cfg.hybrid_attn_every > 0))
        audio = cfg.family == "audio" and cfg.encoder is not None
        if not (dense or routed or self.interleaved or mamba or audio):
            raise NotImplementedError(
                f"family {cfg.family!r} (blocks {self.kind!r}) is not ported; "
                f"the port runs the dense GQA decoder and VLM families, "
                f"llama4's GQA + MoE, deepseek-v2's MLA + MoE, Mamba2, the "
                f"zamba2 hybrid and whisper's encoder-decoder")
        if self.interleaved and (moe_every != 2 or cfg.num_layers % 2):
            raise ValueError(
                f"{cfg.name}: an interleaved MoE stack runs periods of one "
                f"dense and one MoE layer (moe_every 2; the reference's scan "
                f"pairs blocks_dense with blocks_moe), so its depth must be "
                f"a multiple of 2; got moe_every {moe_every}, "
                f"{cfg.num_layers} layers")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernel = (self.device.type == "cuda") if use_kernel is None \
            else bool(use_kernel)
        # routed-expert backend override (None = phase-driven auto; see
        # repro_torch.core.experts.select_backend)
        self.backend = backend

    # ------------------------------------------------------------- init

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters from a seeded generator on the model's device.
        The JAX package draws different numbers from the same seed: to run
        both on one set of weights, carry JAX's through the bridge."""
        cfg = self.cfg
        dt = torch_dtype(cfg)
        dev = self.device
        params: dict[str, Any] = {}
        params["embed"] = (torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=generator,
            dtype=torch.float32, device=dev) * cfg.d_model ** -0.5).to(dt)
        params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                           device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = (torch.randn(
                (cfg.d_model, cfg.vocab_size), generator=generator,
                dtype=torch.float32, device=dev) * cfg.d_model ** -0.5
            ).to(dt)
        init_block, _ = B.BLOCKS[self.kind]
        if self.interleaved:
            n_moe = cfg.num_layers // 2
            params["blocks_dense"] = init_stacked(
                lambda: B.init_dense_block(cfg, dt, dev, generator),
                cfg.num_layers - n_moe)
            params["blocks_moe"] = init_stacked(
                lambda: init_block(cfg, dt, dev, generator), n_moe)
        else:
            params["blocks"] = init_stacked(
                lambda: init_block(cfg, dt, dev, generator), cfg.num_layers)
        if cfg.family == "hybrid":
            params["shared_attn"] = B.init_dense_block(cfg, dt, dev,
                                                       generator)
        if cfg.family == "audio":
            enc = cfg.encoder
            params["enc_blocks"] = init_stacked(
                lambda: B.init_dense_block(cfg, dt, dev, generator),
                enc.num_layers)
            params["enc_pos"] = (torch.randn(
                (enc.num_frames, cfg.d_model), generator=generator,
                dtype=torch.float32, device=dev) * 0.02).to(dt)
            params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                             device=dev)
        if cfg.family == "vlm" and cfg.vision and cfg.vision.d_patch:
            params["vision_proj"] = (torch.randn(
                (cfg.vision.d_patch, cfg.d_model), generator=generator,
                dtype=torch.float32, device=dev) * cfg.vision.d_patch ** -0.5
            ).to(dt)
        return params

    # ------------------------------------------------------------ stack

    def _embed(self, params, batch) -> torch.Tensor:
        """Token embeddings; for the VLM family with ``batch["patches"]``
        (B, P, d_patch) the patch embeddings (through ``vision_proj`` where
        the params have one) take the place of the first P positions."""
        tokens = batch["tokens"] if "tokens" in batch else batch["token"]
        x = embed(tokens, params["embed"])
        if self.cfg.family == "vlm" and "patches" in batch:
            patches = batch["patches"].to(x.dtype)
            if "vision_proj" in params:
                patches = matmul(patches, params["vision_proj"])
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        return x

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """whisper's encoder over precomputed frame embeddings (B, F, d)
        (the conv frontend is a stub): the learned positions added, the
        dense blocks run without a causal mask, RoPE or a window, then
        RMSNorm with ``enc_norm`` (RMSNorm, not LayerNorm, as in the
        reference)."""
        cfg = self.cfg
        f = frames.shape[1]
        if f > cfg.encoder.num_frames:
            raise ValueError(f"{f} frames, past the encoder's "
                             f"{cfg.encoder.num_frames} positions")
        x = frames.to(torch_dtype(cfg)) + params["enc_pos"][None, :f]
        ctx = BlockCtx(positions=torch.arange(f, device=x.device),
                       cache=None, cache_pos=None, window=0, causal=False,
                       use_rope=False, use_kernel=self.use_kernel)
        blocks = params["enc_blocks"]
        for li in range(cfg.encoder.num_layers):
            x, _, _ = B.dense_block(x, tree_map(lambda a: a[li], blocks),
                                    cfg, ctx)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _enc_out(self, params, batch):
        """The encoder's output over ``batch["frames"]`` for the audio
        family, else None."""
        if self.cfg.family != "audio":
            return None
        if "frames" not in batch:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder: its batch needs "
                f"'frames', precomputed frame embeddings (B, F, "
                f"{self.cfg.d_model}), beside 'tokens'")
        return self._encode(params, batch["frames"])

    def _stack(self, params, x: torch.Tensor, *, caches=None,
               cache_pos=None, capture: bool = False,
               phase: str = "prefill", backend: Optional[str] = None,
               token_valid=None, block_tables=None, row_slots=None,
               row_k=None, cross=None, remat: bool = False):
        """Run the layer stack. ``cache_pos`` is an int shared by the batch
        or a per-slot (B,) tensor. ``cross`` feeds the audio family's
        cross-attention: the encoder's output (B, F, d), which each layer
        projects, or the projected (k, v) of (L, B, F, KH, hd), one slice a
        layer. ``remat`` runs each layer under activation checkpointing
        (only its input is kept; the backward recomputes the rest), the
        reference's ``_maybe_remat(body, True)``. Returns (x, caches, aux)
        with aux["ffn_in"] stacked over layers when ``capture`` (for an
        interleaved stack a dict {"moe", "dense"}, each stacked over its
        own layers), aux["dropped"] summed over layers and aux["load"] the
        routed layers' expert utilization stacked as (L, E) (an
        interleaved stack's MoE layers only)."""
        cfg = self.cfg
        seq = x.shape[1]
        if isinstance(cache_pos, torch.Tensor):
            # per-slot offsets -> (B, S) rope positions
            positions = cache_pos.long()[:, None] + \
                torch.arange(seq, device=x.device)
        else:
            start = int(cache_pos) if cache_pos is not None else 0
            positions = torch.arange(start, start + seq, device=x.device)
        base = BlockCtx(positions=positions, cache=None, cache_pos=cache_pos,
                        window=0, causal=True, use_rope=True,
                        use_kernel=self.use_kernel, capture=capture,
                        phase=phase,
                        backend=backend if backend is not None
                        else self.backend,
                        token_valid=token_valid, block_table=block_tables,
                        row_slots=row_slots, row_k=row_k)
        if cfg.family == "hybrid":
            return self._stack_hybrid(params, x, base, caches, remat)
        taps: dict[str, list] = {}
        dropped, loads = [], []
        for li, (block_fn, blocks, i, window, tap) in enumerate(
                self._layers(params)):
            p = tree_map(lambda a: a[i], blocks)
            cache_l = None if caches is None else \
                (caches[0][li], caches[1][li])
            cross_l = cross if not isinstance(cross, tuple) else \
                (cross[0][li], cross[1][li])
            x, _, aux = _maybe_remat(block_fn, remat)(
                x, p, cfg, base._replace(cache=cache_l, window=window,
                                         cross_kv=cross_l))
            if capture:
                taps.setdefault(tap, []).append(aux["ffn_in"])
            if "dropped" in aux:
                dropped.append(aux["dropped"])
            if "load" in aux:
                loads.append(aux["load"])
        out = {}
        if capture:
            out["ffn_in"] = {k: torch.stack(v) for k, v in taps.items()} \
                if self.interleaved else torch.stack(taps[None])
        if dropped:
            out["dropped"] = torch.stack(dropped).sum()
        if loads:
            out["load"] = torch.stack(loads)
        return x, caches, out

    def _layers(self, params) -> list:
        """(block_fn, stacked block params, index into them, window, tap
        key) for each layer in model order, which is the cache's layer
        order. An interleaved stack's period i runs dense layer i and then
        MoE layer i, with no window (the reference's scan over periods
        takes none) and their FFN inputs tapped apart."""
        cfg = self.cfg
        if self.interleaved:
            return [layer for i in range(cfg.num_layers // 2) for layer in (
                (B.dense_block, params["blocks_dense"], i, 0, "dense"),
                (B.moe_block, params["blocks_moe"], i, 0, "moe"))]
        _, block_fn = B.BLOCKS[self.kind]
        return [(block_fn, params["blocks"], li, window, None)
                for li, window in enumerate(layer_windows(cfg))]

    def _stack_hybrid(self, params, x: torch.Tensor, base: BlockCtx,
                      caches, remat: bool = False):
        """zamba2: the Mamba2 layers, and ONE shared attention + FFN block
        applied after every ``hybrid_attn_every``-th layer, with its own KV
        cache slice per application (``aidx``). Caches are updated in
        place; a Python ``if`` takes the place of the reference's
        ``lax.cond``. With ``remat`` each layer (its Mamba2 block and the
        shared block after it) runs under one checkpoint, as the
        reference's scan body. Returns (x, caches, {})."""
        cfg = self.cfg
        is_attn, app_idx, _ = hybrid_attn_layers(cfg)
        mamba_caches, attn_k, attn_v = (caches if caches is not None
                                        else (None, None, None))
        blocks = params["blocks"]
        shared = params["shared_attn"]

        def layer(x, p, m_cache, ctx):
            x, _, _ = B.mamba_block(x, p, cfg, base._replace(cache=m_cache))
            if ctx is not None:
                x, _, _ = B.dense_block(x, shared, cfg, ctx)
            return x

        for li in range(cfg.num_layers):
            p = tree_map(lambda a: a[li], blocks)
            m_cache = None if mamba_caches is None else \
                (mamba_caches[0][li], mamba_caches[1][li])
            ctx = None
            if is_attn[li]:
                if attn_k is not None:
                    aidx = app_idx[li]
                    ctx = base._replace(cache=(attn_k[aidx], attn_v[aidx]))
                else:
                    ctx = base._replace(cache=None, cache_pos=None)
            x = _maybe_remat(layer, remat)(x, p, m_cache, ctx)
        return x, caches, {}

    # ------------------------------------------------------------ public

    def _head(self, params):
        return params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (small models/tests only). The audio
        family's batch carries ``frames`` beside the tokens."""
        x = self._embed(params, batch)
        x, _, _ = self._stack(params, x, cross=self._enc_out(params, batch))
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return unembed(x, self._head(params), self.cfg.tie_embeddings)

    def hidden_states(self, params, batch) -> torch.Tensor:
        """Stack output before the final norm (as the JAX reference)."""
        x = self._embed(params, batch)
        x, _, _ = self._stack(params, x, cross=self._enc_out(params, batch))
        return x

    def ffn_inputs(self, params, batch):
        """Per-layer pre-FFN activations over a calibration batch, the x
        whose FFN hidden states CMoE profiles: (L, B, S, d), or for an
        interleaved stack a dict {"moe": ..., "dense": ...} of (L/2, B, S,
        d) each."""
        x = self._embed(params, batch)
        _, _, aux = self._stack(params, x, capture=True,
                                cross=self._enc_out(params, batch))
        return aux["ffn_in"]

    def loss(self, params, batch, *, remat: bool = True,
             ce_chunk: int = 512):
        """Next-token cross-entropy, the logits computed a sequence chunk at
        a time (never (B, S, V)). Reads ``tokens[:, :-1]`` and predicts
        ``tokens[:, 1:]``; the VLM family's patch positions are masked out
        of the mean, the audio family's encoder runs over
        ``batch["frames"]``. Returns (loss, metrics), metrics["moe_load"]
        the routed layers' (L, E) utilization where the model has routed
        experts.

        Raises when the model's kernels are on and autograd is recording:
        the CUDA wrappers return tensors with no autograd graph, so a loss
        through them would leave the FFN and attention weights without
        gradients (the reference's kernels have no VJP either). Build a
        model to train with ``use_kernel=False``."""
        if self.use_kernel and torch.is_grad_enabled():
            raise RuntimeError(
                "Model.loss with use_kernel=True under autograd: the kernels "
                "have no backward, so their weights would get no gradient; "
                "build the model with use_kernel=False to train")
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, {**batch, "tokens": tokens[:, :-1]})
        x, _, aux = self._stack(params, x, cross=self._enc_out(params, batch),
                                remat=remat)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        targets = tokens[:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=x.device)
        if cfg.family == "vlm" and "patches" in batch:
            mask[:, :batch["patches"].shape[1]] = 0.0
        loss = chunked_ce(x, self._head(params), cfg.tie_embeddings,
                          targets, mask, chunk=ce_chunk)
        metrics = {}
        if "load" in aux:
            metrics["moe_load"] = aux["load"]             # (L, E)
        return loss, metrics

    # ------------------------------------------------------------ caches

    def _cache_leaves(self, lead: tuple) -> tuple:
        """Zero cache leaves (L, *lead, per-token dims): K and V of (KH,
        hd), or MLA's latent (r,) and rope key (dr,)."""
        cfg = self.cfg
        if self.kind == "mla_moe":
            tails = ((cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_head_dim,))
        else:
            tails = ((cfg.num_kv_heads, cfg.resolved_head_dim),) * 2
        dt = torch_dtype(cfg)
        return tuple(torch.zeros((cfg.num_layers, *lead, *tail), dtype=dt,
                                 device=self.device) for tail in tails)

    def init_cache(self, batch_size: int, max_len: int):
        """Contiguous cache: every KV leaf (L, batch_size, max_len, ...);
        for Mamba2 the conv state (L, B, cw-1, di+2N) in the model's dtype
        and the SSM state (L, B, nh, hp, N) in float32, and for the hybrid
        that pair with the shared attention block's k and v of (n_apps,
        batch_size, max_len, KH, hd). The audio family's is {"self": the
        decoder's (k, v), "cross": (k, v) of (L, batch_size, num_frames,
        KH, hd)}."""
        cfg = self.cfg
        if cfg.family == "audio":
            return {"self": self._cache_leaves((batch_size, max_len)),
                    "cross": self._cache_leaves(
                        (batch_size, cfg.encoder.num_frames))}
        if self.kind != "mamba":
            return self._cache_leaves((batch_size, max_len))
        di, n, nh = d_inner(cfg), cfg.ssm.state_size, num_ssm_heads(cfg)
        lead = (cfg.num_layers, batch_size)
        mamba = (torch.zeros((*lead, cfg.ssm.conv_width - 1, di + 2 * n),
                             dtype=torch_dtype(cfg), device=self.device),
                 torch.zeros((*lead, nh, di // nh, n), dtype=torch.float32,
                             device=self.device))
        if cfg.family == "ssm":
            return mamba
        _, _, n_apps = hybrid_attn_layers(cfg)
        shape = (n_apps, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return (mamba,
                torch.zeros(shape, dtype=torch_dtype(cfg), device=self.device),
                torch.zeros(shape, dtype=torch_dtype(cfg), device=self.device))

    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Paged pool: the per-token layout of ``init_cache`` with the
        (B, max_len) lane axes replaced by a flat pool of fixed-size blocks,
        every leaf (L, num_blocks, block_size, ...). Lanes address it
        through per-slot block tables (``step(block_tables=...)``);
        physical block 0 is the trash block that absorbs dummy and spill
        writes (see ``repro_torch.serving.cache.PagedKVCache``). Only the
        slot-addressable KV families the engine serves have one."""
        if self.kind in ("mamba", "encdec"):
            raise NotImplementedError(
                f"paged cache serves the slot-addressable KV families; "
                f"kind={self.kind!r} is not one")
        return self._cache_leaves((num_blocks, block_size))

    def step(self, params, tokens: torch.Tensor, cache, slot_pos, *,
             phase: Optional[str] = None,
             lengths: Optional[torch.Tensor] = None,
             return_stats: bool = False,
             block_tables: Optional[torch.Tensor] = None,
             row_slots: Optional[torch.Tensor] = None,
             row_k: Optional[torch.Tensor] = None,
             backend: Optional[str] = None,
             extras: Optional[dict] = None):
        """The serving engine's one entry point: run tokens (B, S) against
        the cache, writing K/V in place.

        ``slot_pos`` is an int shared by the batch (the static path:
        chunked attention for S > 1, decode attention for S == 1) or a
        per-slot (B,) tensor: each lane writes and attends at its own
        depth (a fresh prefill at 0, a resumed chunk at its cursor, a
        decode at the lane's depth). ``phase`` (default by S; "mixed" for
        a fused step) drives the routed-expert backend. ``lengths`` (B,)
        marks each row's valid token count when prompts are right-padded:
        logits come from position lengths-1 and padding takes no routed
        work. ``block_tables`` (B, nblk) switches the cache to the PAGED
        pool of ``init_paged_cache``; ``row_slots`` (B,) makes a FUSED
        step over the contiguous cache (S must be 1, row r addresses lane
        row_slots[r]); ``row_k`` (B,) is the per-row routed top-k;
        ``backend`` overrides the routed-expert backend for this call;
        ``extras`` carries non-token inputs (the VLM family's patches) to
        the embedder.

        Returns (logits (B, V) at each row's last valid position, cache),
        or with ``return_stats`` (logits, cache, {"dropped": device int}),
        the routed pairs any dispatch failed to keep, summed over layers
        (zero on every engine backend)."""
        cfg = self.cfg
        if cfg.family == "audio":
            raise NotImplementedError(
                "step() serves the KV-cache families; the audio family's "
                "prefill and decode_step keep their encoder-decoder "
                "cross-attention paths")
        s = tokens.shape[1]
        if phase is None:
            phase = "decode" if s == 1 else "prefill"
        x = self._embed(params, {**(extras or {}), "tokens": tokens})
        token_valid = None
        if lengths is not None:
            lengths = lengths.to(x.device)
            token_valid = torch.arange(s, device=x.device)[None, :] < \
                lengths[:, None]
        x, cache, aux = self._stack(params, x, caches=cache,
                                    cache_pos=slot_pos, phase=phase,
                                    backend=backend, token_valid=token_valid,
                                    block_tables=block_tables,
                                    row_slots=row_slots, row_k=row_k)
        if lengths is None:
            xl = x[:, -1:]
        else:
            idx = (lengths.long() - 1)[:, None, None].expand(
                x.shape[0], 1, x.shape[2])
            xl = torch.gather(x, 1, idx)
        logits = self._logits(params, xl)
        if return_stats:
            dropped = aux.get("dropped", torch.zeros((), dtype=torch.int32,
                                                     device=x.device))
            return logits, cache, {"dropped": dropped}
        return logits, cache

    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Forward filling a fresh cache; the batch's other entries (the VLM
        family's patches) go to the embedder. Returns (last-token logits
        (B, V), cache)."""
        tokens = batch["tokens"]
        bsz, seq = tokens.shape
        if self.cfg.family == "audio":
            return self._prefill_audio(params, batch, max_len or seq)
        cache = self.init_cache(bsz, max_len or seq)
        extras = {k: v for k, v in batch.items() if k not in
                  ("tokens", "token")}
        return self.step(params, tokens, cache, 0, phase="prefill",
                         extras=extras or None)

    def decode_step(self, params, token: torch.Tensor, cache, pos: int):
        """One decode step. token: (B, 1); pos: the index the new token is
        written at. Returns (logits (B, V), cache). The audio family
        attends its stored cross cache (the reference's
        _stack_audio_decode)."""
        if self.cfg.family != "audio":
            return self.step(params, token, cache, pos, phase="decode")
        x = self._embed(params, {"tokens": token})
        x, _, _ = self._stack(params, x, caches=cache["self"],
                              cache_pos=pos, phase="decode",
                              cross=cache["cross"])
        return self._logits(params, x[:, -1:]), cache

    def _prefill_audio(self, params, batch, max_len: int):
        """The audio family's prefill: encode the frames, fill the cross
        cache with each layer's projection of the encoder output (F frames,
        as many as the batch holds), and run the decoder over the tokens,
        filling "self" from position 0. The reference projects twice, once
        for the cache and again inside each block from the raw encoder
        output; the port projects once and hands each block its slice of
        the cache, the same product on the same operands."""
        cfg = self.cfg
        enc_out = self._enc_out(params, batch)
        bsz, f = enc_out.shape[0], enc_out.shape[1]
        cross = self._cache_leaves((bsz, f))
        xattn = params["blocks"]["xattn"]
        for li in range(cfg.num_layers):
            k, v = B.cross_kv_project(
                enc_out, tree_map(lambda a: a[li], xattn), cfg)
            cross[0][li], cross[1][li] = k, v
        del enc_out
        cache = {"self": self._cache_leaves((bsz, max_len)), "cross": cross}
        x = self._embed(params, batch)
        x, _, _ = self._stack(params, x, caches=cache["self"], cache_pos=0,
                              cross=cross)
        return self._logits(params, x[:, -1:]), cache

    def _logits(self, params, xl: torch.Tensor) -> torch.Tensor:
        """Logits (B, V) of the stack output at one position a row, xl
        (B, 1, d): the final norm, then the head."""
        xl = rms_norm(xl, params["final_norm"], self.cfg.norm_eps)
        return unembed(xl, self._head(params), self.cfg.tie_embeddings)[:, 0]


def _maybe_remat(fn, remat: bool):
    """fn itself, or fn under non-reentrant activation checkpointing: only
    its inputs are kept, and the backward recomputes its activations."""
    if not remat:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def chunked_ce(x: torch.Tensor, head: torch.Tensor, tied: bool,
               targets: torch.Tensor, mask: torch.Tensor, chunk: int = 512
               ) -> torch.Tensor:
    """Mean cross-entropy over the positions ``mask`` keeps, a chunk of
    ``chunk`` positions at a time. Each chunk's float32 logits (B, chunk,
    V) are made under a checkpoint, so the backward recomputes them and
    (B, S, V) never exists. x: (B, S, d) after the final norm; targets,
    mask: (B, S)."""
    s = x.shape[1]
    chunk = min(chunk, s)

    def chunk_loss(xb, tb, mb, head):
        logits = unembed(xb, head, tied).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tb[..., None].long())[..., 0]
        return ((lse - gold) * mb).sum(), mb.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        nll, n = torch.utils.checkpoint.checkpoint(
            chunk_loss, x[:, sl], targets[:, sl], mask[:, sl], head,
            use_reentrant=False)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def build_model(cfg: ModelConfig, use_kernel: Optional[bool] = None,
                backend: Optional[str] = None, device=None) -> Model:
    return Model(cfg, use_kernel=use_kernel, backend=backend, device=device)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + blocks), from shapes only."""
    model = Model(cfg, use_kernel=False, device="meta")
    return sum(math.prod(t.shape) for t in tree_leaves(model.init()))

