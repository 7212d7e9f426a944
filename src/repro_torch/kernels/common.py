"""Helpers shared by the kernel modules: the activations of the plain
versions, and the operand checks every CUDA wrapper runs before it hands
raw pointers to a kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {"swiglu": 0, "geglu": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def act(name: str):
    """swiglu -> swish; geglu -> tanh-approximate gelu (jax.nn.gelu's
    default, not torch's exact default)."""
    if name == "swiglu":
        return lambda v: v * torch.sigmoid(v)
    if name == "geglu":
        return lambda v: F.gelu(v, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def act_code(name: str) -> int:
    if name not in ACTS:
        raise ValueError(f"the kernels take {sorted(ACTS)}, not {name!r}")
    return ACTS[name]


def check_float_operands(*tensors: torch.Tensor) -> tuple[int, torch.device]:
    """All on one CUDA device, one dtype the kernels take, contiguous.
    Returns (dtype code, device)."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    if dt not in DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16, not {dt}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
        if t.dtype != dt:
            raise TypeError(f"mixed dtypes {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    return DTYPES[dt], dev


def check_ids(ids: torch.Tensor, n: int, device: torch.device) -> None:
    if ids.dtype != torch.int32 or ids.device != device \
            or not ids.is_contiguous() or ids.shape != (n,):
        raise ValueError(f"ids must be a contiguous int32 ({n},) tensor on "
                         f"{device}; got {ids.dtype} {tuple(ids.shape)} on "
                         f"{ids.device}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
