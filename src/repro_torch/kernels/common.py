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


# csrc/decode_split.cuh kChunk: the logical key positions one block of the
# split-KV decode core takes. A constant, never chosen from a call's rows,
# block size or table width: a row's arithmetic must not depend on them.
DECODE_CHUNK = 256
# csrc/mla_tc.cuh kChunk: the same for mla_paged_decode's tensor-core
# route, whose partials are latent rows of r 512 (a longer chunk keeps
# their bytes a fraction of the keys')
MLA_CHUNK = 1024


def decode_chunks(view: int, chunk: int = DECODE_CHUNK) -> int:
    """Chunks of `chunk` keys that a view of `view` key positions spans: a
    split decode kernel's grid per (row, head); above 1 its merge runs."""
    if view < 1:
        raise ValueError(f"a decode view holds at least one key; got {view}")
    return -(-view // chunk)


def decode_workspace(rows: int, heads: int, hd: int, view: int,
                     device: torch.device, chunk: int = DECODE_CHUNK):
    """(nch, buf, part_acc, part_ml) for a split decode call over chunks of
    `chunk` keys: one float32 allocation `buf` (the caller keeps it alive
    across the launch) holding the partials (rows, heads, nch, hd) at
    pointer part_acc and their (m, l) pairs (rows, heads, nch, 2) at pointer
    part_ml; or None and two NULL pointers where the view fits one chunk
    (the split kernel then writes the output itself and no merge runs)."""
    nch = decode_chunks(view, chunk)
    if nch == 1:
        return nch, None, 0, 0
    n = rows * heads * nch
    buf = torch.empty(n * (hd + 2), dtype=torch.float32, device=device)
    base = buf.data_ptr()
    return nch, buf, base, base + 4 * n * hd


def stream_ptr(device: torch.device) -> int:
    """The raw handle of the current stream on `device` (a CUDA tensor's
    device always carries its index), read without building a torch Stream
    object: every wrapper calls it once a launch. The binding is in every
    CUDA build of PyTorch since 2.0 (Inductor's and Triton's launchers read
    it); the port runs on 2.11."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
