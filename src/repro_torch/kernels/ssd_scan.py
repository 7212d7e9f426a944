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
and h up to rounding. The CUDA kernels are ``csrc/ssd_scan.cu`` (its
source note states the bound on an H100 and the design): the SSD chunked
form in three passes over chunks of ``KERNEL_CHUNK`` rows (``SHORT_CHUNK``
where the state is wider than 128 or the sequence fits in it), whatever
chunk the caller names, from ``h0``. ``ssd_scan_plain`` below is the
chunked algorithm of ``ssd_chunked`` in float32 at the caller's chunk, and
is what a CPU tensor runs; ``ssd_chunk_states_plain``,
``ssd_state_pass_plain`` and ``ssd_chunk_out_plain`` mirror the three
passes one by one, and ``ssd_scan_passes_plain`` composes them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, raise_on_error, stream_ptr

# csrc/ssd_scan.cu: rows per chunk, head channels per block, the state
# widths the kernels are built for, and the shared memory a block may use
KERNEL_CHUNK = 64
SHORT_CHUNK = 32
SLICE = 64
STATE_WIDTHS = (64, 128, 256)
MAX_SMEM_BYTES = 232448
# heads a chunk_out block takes: the most (up to MAX_HEADS_PER_BLOCK, a
# divisor of nh) that leave MIN_BLOCKS_PER_SM blocks an SM
MAX_HEADS_PER_BLOCK = 8
MIN_BLOCKS_PER_SM = 3


def _state_width(n: int) -> int:
    """The padded state width a block holds: 64, 128, 256, or the next
    power of two past them (which no kernel is built for)."""
    width = STATE_WIDTHS[0]
    while width < n:
        width *= 2
    return width


def kernel_chunk(seq: int, n: int) -> int:
    """The chunk the CUDA kernels walk: SHORT_CHUNK where the sequence fits
    in it (one chunk, and no tile row is padding) or the state is wider
    than 128 (a block of 64-row chunks would not fit), else KERNEL_CHUNK."""
    return SHORT_CHUNK if seq <= SHORT_CHUNK or n > 128 else KERNEL_CHUNK


def smem_bytes(n: int, chunk: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one chunk_out block (the largest of the
    three kernels) for x, B and C of `itemsize` bytes: C and B rows of the
    chunk and two buffers of a 64-channel start state, padded to the state
    width + 4 floats; xw^T (64 channels) and the masked C B^T, padded to
    the chunk + 4; two buffers of raw x rows (64 channels + 16 bytes) and
    of dt; l and exp(l_end - l)."""
    ns, ls = _state_width(n) + 4, chunk + 4
    x_raw = chunk * (SLICE * itemsize + 16) // 4
    return 4 * (2 * chunk * ns + 2 * SLICE * ns + SLICE * ls + chunk * ls +
                2 * x_raw + 4 * chunk)


def heads_per_block(bsz: int, nc: int, nh: int, hp: int, sms: int) -> int:
    """hg, the heads one chunk_out block takes in turn (sharing C B^T): the
    largest power of two up to MAX_HEADS_PER_BLOCK dividing nh that leaves
    at least MIN_BLOCKS_PER_SM blocks per SM."""
    blocks = bsz * nc * nh * -(-hp // SLICE)
    hg = 1
    while hg < MAX_HEADS_PER_BLOCK and nh % (2 * hg) == 0 and \
            blocks // (2 * hg) >= MIN_BLOCKS_PER_SM * sms:
        hg *= 2
    return hg


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) float32 zero-padded to whole chunks of `chunk` rows and
    cut into them: (B, nc, chunk, ...)."""
    pad = (-t.shape[1]) % chunk
    t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def _operands(xh, dt, b, a_log, chunk):
    """xw, dta and B in float32, cut into chunks of `chunk` rows (padded
    rows: dta = 0, xw = B = 0): (B, nc, L, nh, hp), (B, nc, L, nh), (B,
    nc, L, N)."""
    a = -torch.exp(a_log.float())
    return (_chunks(xh.float() * dt.float()[..., None], chunk),
            _chunks(dt.float() * a, chunk), _chunks(b, chunk))


def _chunk_state(xw_c, dta_c, b_c):
    """(xw * exp(l_end - l))^T B of one chunk and its l (B, L, nh)."""
    l = torch.cumsum(dta_c, dim=1)
    w = torch.exp(l[:, -1:, :] - l)
    return torch.einsum("bshp,bsn->bhpn", xw_c * w[..., None], b_c), l


def _scan(xh, dt, b, c, a_log, d_skip, chunk, h0, starts=None):
    """The chunk loop of ssd_scan_plain and ssd_chunk_out_plain: y of every
    chunk from its start state, and h_fin. Chunk 0 starts from h0 (None:
    zeros); chunk i > 0 from starts[:, i - 1] where starts is given, else
    from the state the loop carried out of chunk i - 1."""
    bsz, s, nh, hp = xh.shape
    xw, dta, bm = _operands(xh, dt, b, a_log, chunk)
    cm = _chunks(c, chunk)
    nc = xw.shape[1]
    h = torch.zeros((bsz, nh, hp, b.shape[-1]), dtype=torch.float32,
                    device=xh.device) if h0 is None else h0.float()
    above = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    ys = []
    for i in range(nc):
        if starts is not None and i > 0:
            h = starts[:, i - 1]
        xw_c, b_c, c_c = xw[:, i], bm[:, i], cm[:, i]
        st, l = _chunk_state(xw_c, dta[:, i], b_c)            # l (B,Lc,nh)
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
        ys.append(y_intra + y_inter)
        h = h * torch.exp(l[:, -1])[..., None, None] + st
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, nh, hp)[:, :s]
    return y + xh.float() * d_skip.float()[:, None], h


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   chunk: int, h0: Optional[torch.Tensor] = None):
    """The chunked SSD scan in float32.

    xh: (B, S, nh, hp); dt: (B, S, nh) (post-softplus); b, c: (B, S, N);
    a_log: (nh,) with A = -exp(a_log); d_skip: (nh,); h0: (B, nh, hp, N)
    or None (zeros). Returns y (B, S, nh, hp) and h_final (B, nh, hp, N),
    both float32."""
    return _scan(xh, dt, b, c, a_log, d_skip, min(chunk, xh.shape[1]), h0)


def ssd_chunk_states_plain(xh: torch.Tensor, dt: torch.Tensor,
                           b: torch.Tensor, a_log: torch.Tensor, chunk: int):
    """Pass 1 (csrc/ssd_scan.cu chunk_states): for every chunk of `chunk`
    rows but the last, its state from zero, (xw * exp(l_end - l))^T B, and
    its total log-decay l_end. Returns (states (B, nc-1, nh, hp, N), lend
    (B, nc-1, nh)), float32."""
    xw, dta, bm = _operands(xh, dt, b, a_log, chunk)
    states, lend = [], []
    for i in range(xw.shape[1] - 1):
        st, l = _chunk_state(xw[:, i], dta[:, i], bm[:, i])
        states.append(st)
        lend.append(l[:, -1])
    bsz, nh, hp, n = xh.shape[0], xh.shape[2], xh.shape[3], b.shape[-1]
    if not states:
        return (torch.zeros((bsz, 0, nh, hp, n), device=xh.device),
                torch.zeros((bsz, 0, nh), device=xh.device))
    return torch.stack(states, 1), torch.stack(lend, 1)


def ssd_state_pass_plain(states: torch.Tensor, lend: torch.Tensor,
                         h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 2 (state_pass): the start state of chunks 1 .. nc-1, h_{c+1} =
    h_c * exp(lend_c) + S_c from h_0 = h0 (None: zeros). Returns a new
    (B, nc-1, nh, hp, N) float32 tensor."""
    if states.shape[1] == 0:
        return states.clone()
    h = torch.zeros_like(states[:, 0]) if h0 is None else h0.float()
    starts = []
    for i in range(states.shape[1]):
        h = h * torch.exp(lend[:, i])[..., None, None] + states[:, i]
        starts.append(h)
    return torch.stack(starts, 1)


def ssd_chunk_out_plain(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, a_log: torch.Tensor,
                        d_skip: torch.Tensor, chunk: int,
                        h0: Optional[torch.Tensor],
                        starts: torch.Tensor):
    """Pass 3 (chunk_out): y of every chunk from its start state (h0 or
    zeros for chunk 0, starts[:, c - 1] after), and h_fin from the last
    chunk's. Returns (y (B, S, nh, hp), h_fin (B, nh, hp, N)), float32."""
    return _scan(xh, dt, b, c, a_log, d_skip, chunk, h0, starts)


def ssd_scan_passes_plain(xh: torch.Tensor, dt: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor,
                          a_log: torch.Tensor, d_skip: torch.Tensor,
                          chunk: int, h0: Optional[torch.Tensor] = None):
    """The three passes of the CUDA kernels composed at `chunk`: the same
    function as ssd_scan_plain (y and h_fin, float32)."""
    states, lend = ssd_chunk_states_plain(xh, dt, b, a_log, chunk)
    starts = ssd_state_pass_plain(states, lend, h0)
    return ssd_chunk_out_plain(xh, dt, b, c, a_log, d_skip, chunk, h0,
                               starts)


def _rows_strided(t: torch.Tensor) -> torch.Tensor:
    """t itself when each (batch, seq) row of it is contiguous (the kernel
    takes batch and sequence strides), else a contiguous copy."""
    want = 1
    for dim in range(t.dim() - 1, 1, -1):
        if t.stride(dim) != want:
            return t.contiguous()
        want *= t.shape[dim]
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(xh, dt, b, c, a_log, d_skip, h0):
    """Raises on operands the kernels do not take; returns the operands the
    kernels read (strided views kept, the rest contiguous)."""
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
    if s < 1:
        raise ValueError("the kernels scan at least one row")
    chunk = kernel_chunk(s, n)
    need = smem_bytes(n, chunk, xh.element_size())
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"state {n} needs {need} bytes of shared memory a "
                         f"block, over the {MAX_SMEM_BYTES} a block may use")
    return (_rows_strided(xh), _rows_strided(dt), _rows_strided(b),
            _rows_strided(c), a_log.contiguous(), d_skip.contiguous(),
            None if h0 is None else h0.contiguous())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def chunk_states_cuda(xh, dt, b, a_log, chunk: int, ws: torch.Tensor,
                      lend: torch.Tensor) -> None:
    """Pass 1 into ws (B, nc-1, nh, hp, N4) and lend (B, nc-1, nh), float32
    and contiguous (N4: N rounded up to 4). xh, dt and b as ssd_scan_cuda
    takes them, after its checks."""
    err = build.entry("ssd_chunk_states_launch")(
        xh.data_ptr(), dt.data_ptr(), b.data_ptr(), a_log.data_ptr(),
        ws.data_ptr(), lend.data_ptr(), xh.shape[0], xh.shape[1],
        xh.shape[2], xh.shape[3], b.shape[-1], xh.stride(0), xh.stride(1),
        dt.stride(0), dt.stride(1), b.stride(0), b.stride(1), chunk,
        DTYPES[xh.dtype], stream_ptr(xh.device))
    raise_on_error(err, "ssd_scan chunk_states")


def state_pass_cuda(h0: Optional[torch.Tensor], ws: torch.Tensor,
                    lend: torch.Tensor, seq: int, n: int, chunk: int) -> None:
    """Pass 2, in place over ws: the start states of chunks 1 .. nc-1."""
    bsz, _, nh, hp, _ = ws.shape
    err = build.entry("ssd_state_pass_launch")(
        _ptr(h0), ws.data_ptr(), lend.data_ptr(), bsz, seq, nh, hp, n,
        chunk, stream_ptr(ws.device))
    raise_on_error(err, "ssd_scan state_pass")


def chunk_out_cuda(xh, dt, b, c, a_log, d_skip, h0, ws, chunk: int,
                   hg: int):
    """Pass 3: (y, h_fin) from h0 and the start states in ws (None when
    the sequence fits in one chunk)."""
    bsz, s, nh, hp = xh.shape
    n = b.shape[-1]
    dev = xh.device
    y = torch.empty((bsz, s, nh, hp), dtype=torch.float32, device=dev)
    h_fin = torch.empty((bsz, nh, hp, n), dtype=torch.float32, device=dev)
    err = build.entry("ssd_chunk_out_launch")(
        xh.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d_skip.data_ptr(), _ptr(h0), _ptr(ws),
        y.data_ptr(), h_fin.data_ptr(), bsz, s, nh, hp, n, xh.stride(0),
        xh.stride(1), dt.stride(0), dt.stride(1), b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), chunk, hg, DTYPES[xh.dtype],
        stream_ptr(dev))
    raise_on_error(err, "ssd_scan chunk_out")
    return y, h_fin


def workspace(bsz: int, nc: int, nh: int, hp: int, n: int,
              device: torch.device):
    """(buf, ws, lend): one float32 allocation holding the chunk states ws
    (B, nc-1, nh, hp, N4) and lend (B, nc-1, nh); the caller keeps buf
    alive across the launches."""
    n4 = -(-n // 4) * 4
    size = bsz * (nc - 1) * nh * hp * n4
    buf = torch.empty(size + bsz * (nc - 1) * nh, dtype=torch.float32,
                      device=device)
    return (buf, buf[:size].view(bsz, nc - 1, nh, hp, n4),
            buf[size:].view(bsz, nc - 1, nh))


def ssd_scan_cuda(xh: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                  h0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernels on the current stream: chunk_out alone where
    the sequence fits in one chunk, else chunk_states, state_pass and
    chunk_out over one workspace. xh, b and c are float32 or bfloat16 (one
    type); dt, a_log, d_skip and h0 float32. xh, dt, b and c are read
    through their batch and sequence strides (the model hands over views
    of the conv output); h0 None starts from zeros. Returns (y (B, S, nh,
    hp), h_fin (B, nh, hp, N)), float32."""
    xh, dt, b, c, a_log, d_skip, h0 = _check(xh, dt, b, c, a_log, d_skip,
                                             h0)
    bsz, s, nh, hp = xh.shape
    n = b.shape[-1]
    chunk = kernel_chunk(s, n)
    nc = -(-s // chunk)
    hg = heads_per_block(bsz, nc, nh, hp, _sm_count(xh.device.index))
    if nc == 1:
        return chunk_out_cuda(xh, dt, b, c, a_log, d_skip, h0, None, chunk,
                              hg)
    buf, ws, lend = workspace(bsz, nc, nh, hp, n, xh.device)
    chunk_states_cuda(xh, dt, b, a_log, chunk, ws, lend)
    state_pass_cuda(h0, ws, lend, s, n, chunk)
    return chunk_out_cuda(xh, dt, b, c, a_log, d_skip, h0, ws, chunk, hg)
