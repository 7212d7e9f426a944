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


def ffn_route(dtype: torch.dtype, d: int, m: int) -> str:
    """The CUDA kernel that serves a call of one of the four FFN kernels
    (swiglu_ffn, moe_gmm_ragged, moe_gather, moe_gmm): "tensor_core"
    (csrc/ffn_tc.cuh) for bfloat16 with d and m multiples of 8, the 16-byte
    row strides its TMA loads need; else "simt" (csrc/ffn_core.cuh: float32
    at any width, bfloat16 off that grid)."""
    if dtype == torch.bfloat16 and d % 8 == 0 and m % 8 == 0:
        return "tensor_core"
    return "simt"


def tc_or_simt(routed: str, path) -> str:
    """The kernel a call runs: the route's, or "simt" where the caller asks
    for it. The tensor-core route cannot be forced on operands off it."""
    if path is None or path == routed:
        return routed
    if path == "simt":
        return path
    raise ValueError(f"path {path!r} cannot serve operands routed to "
                     f"{routed!r}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its base is off the 16-byte grid that TMA
    loads need (a contiguous view may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
