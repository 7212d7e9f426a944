"""Model facade for the dense decoder family.

Port of the dense paths of ``repro/models/model.py``. Parameters are nested
dicts of tensors in the JAX layout: block leaves are stacked over layers as
(L, ...), and the reference's ``lax.scan`` over that stack becomes a Python
loop over layers. Caches are (k, v) tuples of (L, B, T, KH, hd) tensors that
``step`` updates in place. Other families (MoE, MLA, SSM, enc-dec, VLM) are
not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.blocks import BlockCtx
from repro_torch.models.layers import embed, rms_norm, unembed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def tree_map(fn, tree):
    """Apply fn to every tensor leaf of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_stack(trees: list):
    """Stack a list of same-structured nested dicts leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_leaves(tree) -> list:
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
        if cfg.family != "dense" or cfg.moe is not None or \
                cfg.mla is not None:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; the port runs "
                f"the dense GQA decoder family")
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
        params["blocks"] = tree_stack([
            B.init_dense_block(cfg, dt, dev, generator)
            for _ in range(cfg.num_layers)])
        return params

    # ------------------------------------------------------------ stack

    def _embed(self, params, batch) -> torch.Tensor:
        tokens = batch["tokens"] if "tokens" in batch else batch["token"]
        return embed(tokens, params["embed"])

    def _stack(self, params, x: torch.Tensor, *, caches=None,
               cache_pos: Optional[int] = None, capture: bool = False,
               phase: str = "prefill", backend: Optional[str] = None):
        """Run the layer stack. Returns (x, caches, aux) with aux["ffn_in"]
        stacked over layers when ``capture``."""
        cfg = self.cfg
        seq = x.shape[1]
        start = int(cache_pos) if cache_pos is not None else 0
        positions = torch.arange(start, start + seq, device=x.device)
        window = cfg.sliding_window
        base = BlockCtx(positions=positions, cache=None, cache_pos=cache_pos,
                        window=window, causal=True, use_rope=True,
                        use_kernel=self.use_kernel, capture=capture,
                        phase=phase,
                        backend=backend if backend is not None
                        else self.backend)
        blocks = params["blocks"]
        taps = []
        for li in range(cfg.num_layers):
            p = tree_map(lambda a: a[li], blocks)
            cache_l = None if caches is None else \
                (caches[0][li], caches[1][li])
            x, _, aux = B.dense_block(x, p, cfg, base._replace(cache=cache_l))
            if capture:
                taps.append(aux["ffn_in"])
        aux = {"ffn_in": torch.stack(taps)} if capture else {}
        return x, caches, aux

    # ------------------------------------------------------------ public

    def _head(self, params):
        return params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (small models/tests only)."""
        x = self._embed(params, batch)
        x, _, _ = self._stack(params, x)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return unembed(x, self._head(params), self.cfg.tie_embeddings)

    def hidden_states(self, params, batch) -> torch.Tensor:
        """Stack output before the final norm (as the JAX reference)."""
        x = self._embed(params, batch)
        x, _, _ = self._stack(params, x)
        return x

    def ffn_inputs(self, params, batch) -> torch.Tensor:
        """Per-layer pre-FFN activations over a calibration batch, the x
        whose FFN hidden states CMoE profiles: (L, B, S, d)."""
        x = self._embed(params, batch)
        _, _, aux = self._stack(params, x, capture=True)
        return aux["ffn_in"]

    # ------------------------------------------------------------ caches

    def init_cache(self, batch_size: int, max_len: int):
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = torch_dtype(cfg)
        return (torch.zeros(shape, dtype=dt, device=self.device),
                torch.zeros(shape, dtype=dt, device=self.device))

    def step(self, params, tokens: torch.Tensor, cache, slot_pos: int, *,
             phase: Optional[str] = None, backend: Optional[str] = None):
        """Run tokens (B, S) against the cache at the scalar position
        ``slot_pos`` shared by the batch (the static path: chunked attention
        for S > 1, decode attention for S == 1). K/V are written into
        ``cache`` in place. ``phase`` (default by S) drives the routed-
        expert backend. Returns (logits (B, V) of the last position,
        cache). The per-slot (B,) positions of the serving engine come with
        its slice."""
        cfg = self.cfg
        s = tokens.shape[1]
        if phase is None:
            phase = "decode" if s == 1 else "prefill"
        x = self._embed(params, {"tokens": tokens})
        x, cache, _ = self._stack(params, x, caches=cache,
                                  cache_pos=slot_pos, phase=phase,
                                  backend=backend)
        xl = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = unembed(xl, self._head(params), cfg.tie_embeddings)[:, 0]
        return logits, cache

    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Forward filling a fresh cache. Returns (last-token logits (B, V),
        cache)."""
        tokens = batch["tokens"]
        bsz, seq = tokens.shape
        cache = self.init_cache(bsz, max_len or seq)
        return self.step(params, tokens, cache, 0, phase="prefill")

    def decode_step(self, params, token: torch.Tensor, cache, pos: int):
        """One decode step. token: (B, 1); pos: the index the new token is
        written at. Returns (logits (B, V), cache)."""
        return self.step(params, token, cache, pos, phase="decode")


def build_model(cfg: ModelConfig, use_kernel: Optional[bool] = None,
                backend: Optional[str] = None, device=None) -> Model:
    return Model(cfg, use_kernel=use_kernel, backend=backend, device=device)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + blocks), from shapes only."""
    model = Model(cfg, use_kernel=False, device="meta")
    return sum(math.prod(t.shape) for t in tree_leaves(model.init()))

