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


# Rows per product call of a float32 matmul on the card (see row_matmul)
ROW_TILE = 64


def row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), with each row's result independent of how
    many rows ride the call.

    On the card cuBLAS picks its float32 algorithm by the row count M, and
    a row's fp32 result changes with it (measured on an H100: widths 1 and
    2 already differ), which would let the serving engine's micro-batch
    composition leak into the tokens. A float32 product on CUDA therefore
    runs in fixed-shape tiles of ROW_TILE rows (the last one zero-padded),
    one call per tile, so every row goes through the one algorithm of the
    (ROW_TILE, K) x (K, N) shape. The bfloat16 products of the main path
    measured width-invariant at widths 1..128 and run as one call, as do all
    products on the CPU."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    r = xf.shape[0]
    pad = (-r) % ROW_TILE
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    out = torch.cat([torch.matmul(xf[i:i + ROW_TILE], w)
                     for i in range(0, r + pad, ROW_TILE)])
    return out[:r].reshape(*lead, w.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, output in x.dtype. Torch's float32
    matmul is exact fp32 (TF32 stays off unless a caller turns it on), and
    its bf16 matmul accumulates in fp32 and rounds once, as the reference's
    preferred_element_type=f32 followed by a cast. Width-invariant on the
    card (see row_matmul)."""
    return row_matmul(x, w.to(x.dtype))


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
