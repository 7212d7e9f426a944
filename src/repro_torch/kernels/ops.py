"""Wrappers around the port's kernels: device routing and launch counts.

Port of ``repro/kernels/ops.py`` for the kernels on the convert-and-serve
path, the serving engine, the Mamba2 SSD scan, the bounded-buffer expert
path (``moe_gmm``), the CMoE router's scoring (``router_score``) and the
two attention kernels with no model caller (``flash_attention``,
``flash_decode``): every Pallas entry point of the JAX package. Each
wrapper routes by the device of its operands:

  * a CPU tensor runs the kernel's plain PyTorch version;
  * a CUDA tensor launches the hand-written CUDA kernel, or raises.

There is no fallback: a kernel that fails to build or launch is an error.
The CUDA kernels mask ragged tile edges themselves, so unlike the Pallas
wrappers nothing is padded to block multiples here. Each wrapper adds one to
its entry of ``LAUNCHES`` where it launches its kernel, and nowhere else, so
a run can show which kernels its main path went through.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import moe_gather as _gather
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import swiglu as _swiglu
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                              flash_decode_plain)
from repro_torch.kernels.moe_gather import moe_gather_cuda, moe_gather_plain
from repro_torch.kernels.moe_gmm import (CUDA_TILE_ROWS, moe_gmm_cuda,
                                         moe_gmm_plain, moe_gmm_ragged_cuda,
                                         moe_gmm_ragged_plain)
from repro_torch.kernels.paged_attention import (mla_paged_decode_cuda,
                                                 mla_paged_decode_plain,
                                                 paged_attn_decode_cuda,
                                                 paged_attn_decode_plain)
from repro_torch.kernels.router_score import (router_score_cuda,
                                              router_score_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.kernels.swiglu import swiglu_ffn_cuda, swiglu_ffn_plain

KERNELS = ("swiglu_ffn", "moe_gmm_ragged", "moe_gather", "paged_attn_decode",
           "mla_paged_decode", "ssd_scan", "moe_gmm", "router_score",
           "flash_attention", "flash_decode")
LAUNCHES = {name: 0 for name in KERNELS}
# the kernels with two CUDA routes: launches of each route (which kernel a
# call ran), reset with LAUNCHES
ROUTES = {"swiglu_ffn": _swiglu.ROUTE_LAUNCHES,
          "moe_gmm_ragged": _gmm.RAGGED_ROUTE_LAUNCHES,
          "moe_gather": _gather.ROUTE_LAUNCHES,
          "moe_gmm": _gmm.ROUTE_LAUNCHES,
          "flash_attention": _fa.ROUTE_LAUNCHES,
          "flash_decode": _fd.ROUTE_LAUNCHES,
          "mla_paged_decode": _paged.MLA_ROUTE_LAUNCHES}

# Row tile of the ragged expert layout ``moe_gmm_ragged`` consumes: one
# constant per process, never derived from a shape, because the layout block
# is part of the width-invariance contract (a token's tile shape must not
# depend on its micro-batch). 16 where the plain version runs (as the JAX
# package's interpret mode); on the card, the CUDA kernel's row tile.
RAGGED_BLOCK_CPU = 16


def on_cuda() -> bool:
    """True when a CUDA device is attached to this process."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and no GPU
    is present; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def ragged_block_c() -> int:
    return CUDA_TILE_ROWS if on_cuda() else RAGGED_BLOCK_CPU


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for counts in ROUTES.values():
        counts.clear()


def _route(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for a tensor on {t.device}")


def swiglu_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, *, activation: str = "swiglu"
               ) -> torch.Tensor:
    """x: (..., d); wg/wu: (d, f); wd: (f, d) -> (..., d)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    if not _route(x):
        return swiglu_ffn_plain(xf, wg, wu, wd, activation).reshape(shape)
    out = swiglu_ffn_cuda(xf.contiguous(), wg, wu, wd, activation)
    LAUNCHES["swiglu_ffn"] += 1
    return out.reshape(shape)


def moe_gmm_ragged(xp: torch.Tensor, owner: torch.Tensor, wg: torch.Tensor,
                   wu: torch.Tensor, wd: torch.Tensor, *,
                   activation: str = "swiglu", block_c: int = CUDA_TILE_ROWS
                   ) -> torch.Tensor:
    """xp: (P, d) block-aligned expert-sorted rows, P % block_c == 0;
    owner: (P / block_c,) int32 expert per row tile -> (P, d)."""
    if not _route(xp):
        return moe_gmm_ragged_plain(xp, owner, wg, wu, wd, activation,
                                    block_c)
    out = moe_gmm_ragged_cuda(xp.contiguous(),
                              owner.to(torch.int32).contiguous(), wg, wu,
                              wd, activation, block_c)
    LAUNCHES["moe_gmm_ragged"] += 1
    return out


def moe_gather(xf: torch.Tensor, eidx: torch.Tensor, wg: torch.Tensor,
               wu: torch.Tensor, wd: torch.Tensor, *, top_k: int,
               activation: str = "swiglu") -> torch.Tensor:
    """xf: (T, d); eidx: (T*k,) flat expert ids in [0, E], where the
    sentinel id E marks a dead assignment (zero output row) -> (T*k, d)."""
    eidx = eidx.to(torch.int32).clamp(0, wg.shape[0])
    if not _route(xf):
        return moe_gather_plain(xf, eidx, wg, wu, wd, top_k=top_k,
                                activation=activation)
    out = moe_gather_cuda(xf.contiguous(), eidx.contiguous(), wg, wu, wd,
                          top_k=top_k, activation=activation)
    LAUNCHES["moe_gather"] += 1
    return out


def paged_attn_decode(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, *, table: torch.Tensor,
                      pos: torch.Tensor, window: int = 0, scale: float
                      ) -> torch.Tensor:
    """q: (B, 1, H, hd); k_pool/v_pool: (nblocks, bs, KH, hd); table:
    (B, nblk) block tables (0 = trash/unallocated); pos: (B,) last valid
    logical index per row; window: int sliding window (0 = full). Returns
    (B, 1, H, hd)."""
    if not _route(q):
        return paged_attn_decode_plain(q, k_pool, v_pool, table, pos,
                                       int(window), scale=scale)
    out = paged_attn_decode_cuda(
        q.contiguous(), k_pool, v_pool,
        table.to(device=q.device, dtype=torch.int32).contiguous(),
        pos.to(device=q.device, dtype=torch.int32).reshape(-1).contiguous(),
        int(window), scale=scale)
    LAUNCHES["paged_attn_decode"] += 1
    return out


def mla_paged_decode(q_abs: torch.Tensor, q_pe: torch.Tensor,
                     cc_pool: torch.Tensor, cp_pool: torch.Tensor, *,
                     table: torch.Tensor, pos: torch.Tensor, scale: float
                     ) -> torch.Tensor:
    """q_abs: (B, H, r) queries absorbed through W_uk, in the pools' dtype;
    q_pe: (B, H, dr) rope queries; cc_pool: (nblocks, bs, r) latents;
    cp_pool: (nblocks, bs, dr) rope keys; table: (B, nblk) block tables
    (0 = trash/unallocated); pos: (B,) last valid logical index per row.
    Returns o_lat (B, H, r), the softmax-weighted latent."""
    if not _route(q_abs):
        return mla_paged_decode_plain(q_abs, q_pe, cc_pool, cp_pool, table,
                                      pos, scale=scale)
    dev = q_abs.device
    out = mla_paged_decode_cuda(
        q_abs.contiguous(), q_pe.contiguous(), cc_pool, cp_pool,
        table.to(device=dev, dtype=torch.int32).contiguous(),
        pos.to(device=dev, dtype=torch.int32).reshape(-1).contiguous(),
        scale=scale)
    LAUNCHES["mla_paged_decode"] += 1
    return out


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 128, h0: Optional[torch.Tensor] = None):
    """Drop-in for ``repro_torch.models.ssm.ssd_chunked`` (same signature
    and returns). xh: (B, S, nh, hp); dt: (B, S, nh) post-softplus; b/c:
    (B, S, N); h0: (B, nh, hp, N) or None (zeros). Returns y (B, S, nh,
    hp) and h_fin (B, nh, hp, N), float32.

    Unlike the JAX wrapper, which hands every call with a state to the
    plain scan, the CUDA kernel takes ``h0``, so a prefill from a fresh
    cache runs it. The plain version scans in chunks of ``chunk`` rows;
    the CUDA kernels in chunks of their own (``ssd_scan.kernel_chunk``),
    the same function up to rounding. One call is one launch counted,
    whichever of the kernels' one or three passes it runs."""
    if not _route(xh):
        return ssd_scan_plain(xh, dt, b, c, a_log, d_skip, chunk, h0=h0)
    out = ssd_scan_cuda(xh, dt, b, c, a_log, d_skip, h0=h0)
    LAUNCHES["ssd_scan"] += 1
    return out


def moe_gmm(xbuf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor, *, activation: str = "swiglu") -> torch.Tensor:
    """xbuf: (E, C, d) dense capacity buffers; wg/wu: (E, d, m); wd: (E, m,
    d) -> (E, C, d) in xbuf's dtype. Unlike the JAX wrapper, nothing is
    padded: the CUDA kernel masks ragged C and m itself."""
    if not _route(xbuf):
        return moe_gmm_plain(xbuf, wg, wu, wd, activation)
    out = moe_gmm_cuda(xbuf.contiguous(), wg, wu, wd, activation)
    LAUNCHES["moe_gmm"] += 1
    return out


def router_score(x: torch.Tensor, wg_r: torch.Tensor, wu_r: torch.Tensor, *,
                 activation: str = "swiglu") -> torch.Tensor:
    """x: (T, d); wg_r/wu_r: (d, N_r) -> scores (T, N_r) float32, g and u
    unrounded (``ref.router_score_ref``). Unlike the JAX wrapper, T is not
    padded to a block multiple: the CUDA kernel masks the ragged block."""
    if not _route(x):
        return router_score_plain(x, wg_r, wu_r, activation)
    out = router_score_cuda(x.contiguous(), wg_r, wu_r, activation)
    LAUNCHES["router_score"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BH, T, D) -> (BH, S, D), ``ref.
    flash_attention_ref``'s function (top-left causal mask). Unlike the JAX
    wrapper, nothing is padded and nothing falls back: the CUDA kernel
    masks ragged S and T itself, so the causal S > T case follows the
    oracle and the non-causal ragged case runs the kernel."""
    if not _route(q):
        return flash_attention_plain(q, k, v, causal)
    out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos) -> torch.Tensor:
    """q: (BH, 1, D); k/v: (BH, T, D); pos: an int or a one-element integer
    tensor, the last valid index shared by every row. Returns (BH, 1, D).
    On the card pos reaches the kernel as a device int32 (an int is filled
    there, a tensor copied), so the call makes no host sync. Unlike the JAX
    wrapper, T is not padded, so pos >= T attends exactly the T keys."""
    if not _route(q):
        return flash_decode_plain(q, k, v, pos)
    if isinstance(pos, torch.Tensor):
        pos_d = pos.to(device=q.device, dtype=torch.int32).reshape(1)
    else:
        pos_d = torch.full((1,), int(pos), dtype=torch.int32,
                           device=q.device)
    out = flash_decode_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                            pos_d.contiguous())
    LAUNCHES["flash_decode"] += 1
    return out
