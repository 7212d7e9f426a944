"""Mamba2 SSD (state-space duality) blocks: the chunked parallel form for a
forward or prefill, the recurrent form for decode.

Port of ``repro/models/ssm.py``, with its simplifications: one B/C group,
a depthwise causal conv over the concatenated (x, B, C) channels. The
chunked scan is ``repro_torch.kernels.ssd_scan``: its plain version is
``ssd_chunked`` here, and with ``use_kernel`` the block calls the kernel
wrapper, which on the card launches the CUDA kernel (from the cache's
state too, where the JAX wrapper falls back to the plain scan).

Dtypes follow the reference: ``a_log``, ``d_skip`` and ``dt_bias`` are
float32 in a bf16 model, the SSM state is float32 and the conv state has
the model's dtype; the conv output is rounded to x's dtype after the SiLU,
and y to x's dtype before the gated norm.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.layers import lecun, matmul, rms_norm


def d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def num_ssm_heads(cfg) -> int:
    s = cfg.ssm
    return s.num_heads or d_inner(cfg) // s.head_dim


def _split_proj(zxbcdt: torch.Tensor, cfg):
    di = d_inner(cfg)
    n = cfg.ssm.state_size
    nh = num_ssm_heads(cfg)
    z, xin, b, c, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    return z, xin, b, c, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C); w: (cw, C); returns (y,
    new_state) where state is the last (cw - 1) inputs (for decode).

    A loop of shifted float32 multiply-adds, as the reference's, and not
    ``conv1d``: on the card that goes through cuDNN, in TF32 by default."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+cw-1, C)
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + s, :].float() * w[i].float()
    y = y + bias.float()
    new_state = xp[:, xp.shape[1] - (cw - 1):, :]
    return y.to(x.dtype), new_state


# the chunked SSD scan under the reference's name: the kernel's plain
# version, (x, dt, b, c, a_log, d_skip, chunk, h0=None) -> (y, h_final)
ssd_chunked = ssd_scan_plain


def ssd_step(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
             h: torch.Tensor):
    """Recurrent single-token step. x: (B, 1, nh, hp); h: (B, nh, hp, N).
    Returns (y (B, 1, nh, hp), h_new), float32."""
    a = -torch.exp(a_log.float())
    dt0 = dt[:, 0].float()
    decay = torch.exp(dt0 * a)                             # (B, nh)
    xw = x[:, 0].float() * dt0[..., None]
    h_new = h * decay[..., None, None] + \
        xw[..., None] * b[:, 0].float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), h_new)
    y = y + x[:, 0].float() * d_skip.float()[:, None]
    return y[:, None], h_new


def mamba2_block(x: torch.Tensor, p: dict, cfg, *, cache=None,
                 use_kernel: bool = False):
    """Full Mamba2 mixer block (pre-norm, residual added by the caller).

    x: (B, S, d). cache: (conv_state (B, cw-1, di+2N), ssm_state (B, nh,
    hp, N)) for decode (S == 1) or a carried prefill; both are updated IN
    PLACE (the reference returns new ones) and returned. Returns (y (B, S,
    d), cache or None)."""
    s_cfg = cfg.ssm
    di = d_inner(cfg)
    n = s_cfg.state_size
    nh = num_ssm_heads(cfg)
    hp = di // nh
    bsz, seq, _ = x.shape

    zxbcdt = matmul(x, p["in_proj"])
    z, xin, b, c, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)               # (B, S, di+2N)
    conv_state = cache[0] if cache is not None else None
    conv_out, new_conv_state = _causal_conv(conv_in, p["conv_w"],
                                            p["conv_b"], conv_state)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, b, c = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xin.reshape(bsz, seq, nh, hp)
    h0 = cache[1] if cache is not None else None
    if seq == 1 and cache is not None:
        y, h_fin = ssd_step(xh, dt, b, c, p["a_log"], p["d_skip"], h0)
    elif use_kernel:
        y, h_fin = kops.ssd_scan(xh, dt, b, c, p["a_log"], p["d_skip"],
                                 chunk=s_cfg.chunk_size, h0=h0)
    else:
        y, h_fin = ssd_chunked(xh, dt, b, c, p["a_log"], p["d_skip"],
                               chunk=s_cfg.chunk_size, h0=h0)
    y = y.reshape(bsz, seq, di).to(x.dtype)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["out_norm"],
                 cfg.norm_eps)
    out = matmul(y, p["out_proj"])
    if cache is None:
        return out, None
    cache[0].copy_(new_conv_state)
    cache[1].copy_(h_fin)
    return out, cache


def init_mamba2_block(cfg, dtype, device, generator) -> dict:
    di = d_inner(cfg)
    n = cfg.ssm.state_size
    nh = num_ssm_heads(cfg)
    cw = cfg.ssm.conv_width
    d = cfg.d_model
    proj_out = 2 * di + 2 * n + nh
    f32 = torch.float32
    return {
        "in_proj": lecun((d, proj_out), dtype, device, generator),
        "conv_w": lecun((cw, di + 2 * n), dtype, device, generator),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), dtype=f32, device=device),   # A = -1
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=device),
        "out_norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": lecun((di, d), dtype, device, generator),
    }
