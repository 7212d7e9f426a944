"""Shared layer primitives: norms, RoPE, FFN variants, embeddings.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors.
Matmuls accumulate in float32 and round back to the input dtype, and each
rounding sits where the JAX reference has it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Scales multiply as (1 + scale): zero-initialized scales are identity."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics (the biased variance), output in
    x's dtype. No model path calls it: whisper's encoder ends in
    `rms_norm`, as in the reference."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


# Rows per product call on the card (see row_matmul)
ROW_TILE = 64
# Row counts at which a weight's single-call product is probed (row_matmul)
PROBE_ROWS = 2 * ROW_TILE
# (dtype, weight dtype/shape/strides/device) -> whether one call is
# width-invariant at 1..PROBE_ROWS rows
_ONE_CALL_OK: dict = {}


def _row_tiles(x: torch.Tensor, fn) -> torch.Tensor:
    """fn over fixed ROW_TILE-row slices of x's leading axis (the last one
    zero-padded), concatenated and cut back to x's rows."""
    r = x.shape[0]
    pad = (-r) % ROW_TILE
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    out = torch.cat([fn(x[i:i + ROW_TILE])
                     for i in range(0, r + pad, ROW_TILE)])
    return out[:r]


def _one_call_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a single torch.matmul with w gives every row the bits of the
    PROBE_ROWS-row call at each row count 1..PROBE_ROWS. Probed once per
    weight shape, layout and dtype, on seeded random rows: cuBLAS picks its
    algorithm by shape, not by data."""
    key = (x.dtype, w.dtype, w.shape, w.stride(), w.device)
    ok = _ONE_CALL_OK.get(key)
    if ok is None:
        # outside autograd: a probe made inside a checkpointed layer would
        # save tensors its recomputation (a cache hit) does not
        with torch.no_grad():
            w = w.detach()
            g = torch.Generator(device=w.device)
            g.manual_seed(0)
            probe = torch.randn((PROBE_ROWS, w.shape[0]), generator=g,
                                device=w.device).to(x.dtype)
            full = torch.matmul(probe, w)
            diff = torch.stack([(torch.matmul(probe[:m], w) !=
                                 full[:m]).any()
                                for m in range(1, PROBE_ROWS)])
        ok = _ONE_CALL_OK[key] = not bool(diff.any())
    return ok


def row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), with each row's result independent of how
    many rows ride the call.

    On the card cuBLAS picks its algorithm by the row count M, and a row's
    result can change with it (measured on an H100: float32 widths 1 and 2
    already differ, and so do some bfloat16 products with deepseek-v2's K
    of 5120 at small M), which would let the serving engine's micro-batch
    composition leak into the tokens. So a product on CUDA runs as one call
    only where that was seen to be width-invariant for this weight
    (`_one_call_ok`) and the rows are at most PROBE_ROWS; otherwise it runs
    in fixed-shape tiles of ROW_TILE rows (the last one zero-padded), one
    call per tile, so every row goes through the one algorithm of the
    (ROW_TILE, K) x (K, N) shape, which for a width-invariant weight is the
    single call's. The tiles cost several host launches per product, which
    qwen1.5-0.5b's launch-bound steps feel. On the CPU a product is one
    call."""
    if x.device.type != "cuda" or (
            x.numel() <= PROBE_ROWS * x.shape[-1] and _one_call_ok(x, w)):
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = _row_tiles(x.reshape(-1, x.shape[-1]), lambda t: t @ w)
    return out.reshape(*lead, w.shape[-1])


def head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head products: x (M, H, K) with w (H, K, N) -> (M, H, N) in x's
    dtype, fp32 sums rounded once (a batched product over the heads). On
    the card in fixed ROW_TILE-row tiles, as `row_matmul`."""
    w = w.to(x.dtype)

    def prod(t):
        return torch.bmm(t.transpose(0, 1), w).transpose(0, 1)

    return prod(x) if x.device.type != "cuda" else _row_tiles(x, prod)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, output in x.dtype. Torch's float32
    matmul is exact fp32 (TF32 stays off unless a caller turns it on), and
    its bf16 matmul accumulates in fp32 and rounds once, as the reference's
    preferred_element_type=f32 followed by a cast. Width-invariant on the
    card (see row_matmul)."""
    return row_matmul(x, w.to(x.dtype))


def lecun(shape, dtype, device, generator, fan_in=None) -> torch.Tensor:
    """LeCun-normal weights drawn in float32 from `generator`, then cast
    (scaled in place: one float32 temporary, whatever the shape)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_((1.0 / fan_in) ** 0.5).to(dtype)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half RoPE. x: (..., S, H, D); positions: broadcastable to
    (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- FFN

def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu, jax.nn.gelu's default."""
    return F.gelu(x, approximate="tanh")


def ffn_hidden(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """The FFN hidden state h, the object CMoE profiles.

    swiglu: h = swish(x Wg) * (x Wu); geglu: gelu(x Wg) * (x Wu);
    gelu: gelu(x Wi). act(g) is rounded to x's dtype before the product.
    """
    if activation in ("swiglu", "geglu"):
        g = matmul(x, p["wg"])
        u = matmul(x, p["wu"])
        act = swish if activation == "swiglu" else gelu
        return act(g.float()).to(x.dtype) * u
    if activation == "gelu":
        g = matmul(x, p["wi"])
        return gelu(g.float()).to(x.dtype)
    raise ValueError(f"unknown activation {activation}")


def ffn(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    return matmul(ffn_hidden(x, p, activation), p["wd"])


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool
            ) -> torch.Tensor:
    """Logits in float32 from fp32 sums (not rounded to x's dtype);
    width-invariant on the card (see row_matmul)."""
    w = table_or_head.T if tied else table_or_head
    return row_matmul(x.float(), w.to(x.dtype).float())
