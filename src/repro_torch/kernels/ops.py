"""Wrappers around the port's kernels: device routing and launch counts.

Port of ``repro/kernels/ops.py`` for the three kernels on the static
convert-and-serve path. Each wrapper routes by the device of its operands:

  * a CPU tensor runs the kernel's plain PyTorch version;
  * a CUDA tensor launches the hand-written CUDA kernel, or raises.

There is no fallback: a kernel that fails to build or launch is an error.
The CUDA kernels mask ragged tile edges themselves, so unlike the Pallas
wrappers nothing is padded to block multiples here. Each wrapper adds one to
its entry of ``LAUNCHES`` where it launches its kernel, and nowhere else, so
a run can show which kernels its main path went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gather import moe_gather_cuda, moe_gather_plain
from repro_torch.kernels.moe_gmm import (CUDA_TILE_ROWS, moe_gmm_ragged_cuda,
                                         moe_gmm_ragged_plain)
from repro_torch.kernels.swiglu import swiglu_ffn_cuda, swiglu_ffn_plain

KERNELS = ("swiglu_ffn", "moe_gmm_ragged", "moe_gather")
LAUNCHES = {name: 0 for name in KERNELS}

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
