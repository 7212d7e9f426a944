"""Mamba2 SSD chunk scan: y and the final state of the selective state
space recurrence, from a starting state.

Port of the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` and its
wrapper ``repro/kernels/ops.py::ssd_scan`` (a drop-in for
``repro/models/ssm.py::ssd_chunked``). Per (batch, head), with A =
-exp(a_log), dta = dt * A and xw = x * dt, the sequence is walked in chunks
carrying h (hp x N):

    l = cumsum(dta) within the chunk
    y = ((C B^T) * tril(exp(l_t - l_s))) xw + (C h^T) * exp(l) + D x
    h = h * exp(l_end) + (xw * exp(l_end - l))^T B

The chunk length is not part of the function: any chunk gives the same y
and h up to rounding. The CUDA kernel is ``csrc/ssd_scan.cu`` (its source
note states the bound on an H100 and the design); it walks chunks of
``KERNEL_CHUNK`` rows whatever chunk the caller names, and, unlike the
Pallas kernel, starts from ``h0``. The plain version below is the chunked
algorithm of ``ssd_chunked`` in float32 at the caller's chunk, and is what
a CPU tensor runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, raise_on_error, stream_ptr

# csrc/ssd_scan.cu: rows per chunk, and the shared memory a block may use
KERNEL_CHUNK = 64
MAX_SMEM_BYTES = 232448


def smem_bytes(hp: int, n: int) -> int:
    """Dynamic shared memory of one csrc/ssd_scan.cu block: B and C tiles
    and h with rows padded to N + 1 floats, the xw tile, the masked decay
    matrix, and two chunk-long vectors."""
    lc = KERNEL_CHUNK
    return 4 * (2 * lc * (n + 1) + lc * hp + hp * (n + 1) + lc * lc + 2 * lc)


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   chunk: int, h0: Optional[torch.Tensor] = None):
    """The chunked SSD scan in float32.

    xh: (B, S, nh, hp); dt: (B, S, nh) (post-softplus); b, c: (B, S, N);
    a_log: (nh,) with A = -exp(a_log); d_skip: (nh,); h0: (B, nh, hp, N)
    or None (zeros). Returns y (B, S, nh, hp) and h_final (B, nh, hp, N),
    both float32."""
    bsz, s, nh, hp = xh.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    x32 = xh.float()
    a = -torch.exp(a_log.float())                              # (nh,)
    dta = dt.float() * a                                       # log-decay
    xw = x32 * dt.float()[..., None]
    bm, cm = b.float(), c.float()
    if pad:
        xw = F.pad(xw, (0, 0, 0, 0, 0, pad))
        dta = F.pad(dta, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xw = xw.reshape(bsz, nc, chunk, nh, hp)
    dta = dta.reshape(bsz, nc, chunk, nh)
    bm = bm.reshape(bsz, nc, chunk, n)
    cm = cm.reshape(bsz, nc, chunk, n)
    h = torch.zeros((bsz, nh, hp, n), dtype=torch.float32,
                    device=xh.device) if h0 is None else h0.float()
    above = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    ys = []
    for i in range(nc):
        xw_c, b_c, c_c = xw[:, i], bm[:, i], cm[:, i]
        l = torch.cumsum(dta[:, i], dim=1)                     # (B, Lc, nh)
        # M[t, s] = exp(l_t - l_s) for s <= t; the entries above the
        # diagonal are set to -inf before exp (never inf * 0)
        rel = l[:, :, None, :] - l[:, None, :, :]              # (B,Lc,Lc,nh)
        decay = torch.exp(rel.masked_fill(above[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("btn,bsn->bts", c_c, b_c)
        y_intra = torch.einsum("btsh,bshp->bthp", cb[..., None] * decay,
                               xw_c)
        y_inter = torch.einsum("btn,bhpn->bthp", c_c, h) * \
            torch.exp(l)[..., None]
        l_end = l[:, -1:, :]                                   # (B, 1, nh)
        w = torch.exp(l_end - l)                               # (B, Lc, nh)
        h = h * torch.exp(l_end)[:, 0, :, None, None] + torch.einsum(
            "bshp,bsn->bhpn", xw_c * w[..., None], b_c)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, nh, hp)[:, :s]
    y = y + x32 * d_skip.float()[:, None]
    return y, h


def _rows_strided(t: torch.Tensor) -> torch.Tensor:
    """t itself when each (batch, seq) row of it is contiguous (the kernel
    takes batch and sequence strides), else a contiguous copy."""
    want = 1
    for dim in range(t.dim() - 1, 1, -1):
        if t.stride(dim) != want:
            return t.contiguous()
        want *= t.shape[dim]
    return t


def ssd_scan_cuda(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                  h0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream. xh, b and c are
    float32 or bfloat16 (one type); dt, a_log, d_skip and h0 float32. xh,
    dt, b and c are read through their batch and sequence strides (the
    model hands over views of the conv output); h0 None starts from
    zeros. Returns (y (B, S, nh, hp), h_fin (B, nh, hp, N)), float32."""
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    if xh.dtype not in DTYPES or b.dtype != xh.dtype or c.dtype != xh.dtype:
        raise TypeError(f"xh, b and c must share float32 or bfloat16; got "
                        f"{xh.dtype}, {b.dtype}, {c.dtype}")
    bsz, s, nh, hp = xh.shape
    n = b.shape[-1]
    f32 = [dt, a_log, d_skip] + ([] if h0 is None else [h0])
    shapes = [(bsz, s, nh), (nh,), (nh,), (bsz, nh, hp, n)]
    for t, shape in zip(f32, shapes):
        if t.dtype != torch.float32 or t.device != dev or \
                tuple(t.shape) != shape:
            raise ValueError(f"expected a float32 {shape} tensor on {dev}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, s, n) or t.device != dev:
            raise ValueError(f"{name} must be ({bsz}, {s}, {n}) on {dev}; "
                             f"got {tuple(t.shape)} on {t.device}")
    if smem_bytes(hp, n) > MAX_SMEM_BYTES:
        raise ValueError(f"head dim {hp} and state {n} need "
                         f"{smem_bytes(hp, n)} bytes of shared memory, over "
                         f"the {MAX_SMEM_BYTES} a block may use")
    xh = _rows_strided(xh)
    dt = _rows_strided(dt)
    b = _rows_strided(b)
    c = _rows_strided(c)
    a_log, d_skip = a_log.contiguous(), d_skip.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((bsz, s, nh, hp), dtype=torch.float32, device=dev)
    h_fin = torch.empty((bsz, nh, hp, n), dtype=torch.float32, device=dev)
    err = build.entry("ssd_scan_launch")(
        xh.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d_skip.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_fin.data_ptr(), bsz, s, nh, hp, n, xh.stride(0), xh.stride(1),
        dt.stride(0), dt.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), DTYPES[xh.dtype], stream_ptr(dev))
    raise_on_error(err, "ssd_scan")
    return y, h_fin
