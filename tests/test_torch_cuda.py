"""The CUDA kernels against their plain PyTorch versions, on a GPU only.

This file imports no JAX (the GPU machine has none), so it runs there with
the JAX-importing conftest switched off:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: |err| <= 1e-4 max|ref| in float32 (the same fp32 products summed
in another order), 2e-2 max|ref| in bfloat16 (h is rounded to bf16 before
the down product in both, but from slightly different fp32 values)."""
import os

# cuBLAS is deterministic only with a fixed workspace, which must be set
# before the first cuBLAS call (the training resume test checks bits)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.moe_gather import moe_gather_plain  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain  # noqa: E402
from repro_torch.kernels.swiglu import swiglu_ffn_plain  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_cuda_kernels_match_plain(dtype, act):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def close(got, ref):
        tol = (1e-4 if dt == torch.float32 else 2e-2) * \
            ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol

    # widths that are not multiples of the 64-wide CUDA tiles
    t, d, f, e, m, k = 100, 96, 200, 5, 72, 3
    x = rnd((t, d))
    wg, wu, wd = rnd((d, f), d ** -0.5), rnd((d, f), d ** -0.5), \
        rnd((f, d), f ** -0.5)
    close(tops.swiglu_ffn(x, wg, wu, wd, activation=act),
          swiglu_ffn_plain(x, wg, wu, wd, act))
    bg, bu, bd = rnd((e, d, m), d ** -0.5), rnd((e, d, m), d ** -0.5), \
        rnd((e, m, d), m ** -0.5)
    block = tops.ragged_block_c()
    xp = rnd((3 * block, d))
    own = torch.tensor([4, 0, 2], dtype=torch.int32, device=dev)
    close(tops.moe_gmm_ragged(xp, own, bg, bu, bd, activation=act,
                              block_c=block),
          moe_gmm_ragged_plain(xp, own, bg, bu, bd, act, block))
    ids = torch.randint(0, e, (7 * k,), generator=g, device=dev)
    ids[::4] = e
    got = tops.moe_gather(x[:7], ids, bg, bu, bd, top_k=k, activation=act)
    close(got, moe_gather_plain(x[:7], ids, bg, bu, bd, top_k=k,
                                activation=act))
    assert (got[ids == e] == 0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_reject_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.randn(8, 64, device=dev)
    w = torch.randn(64, 64, device=dev)
    tops.reset_launches()
    tops.swiglu_ffn(x, w, w, w)
    assert tops.LAUNCHES["swiglu_ffn"] == 1
    with pytest.raises(TypeError):
        tops.swiglu_ffn(x, w, w, w.double())
    with pytest.raises(ValueError):
        tops.swiglu_ffn(x, w, w.t(), w)          # not contiguous
    with pytest.raises(ValueError):
        tops.swiglu_ffn(x, w, w, w.cpu())        # another device
    with pytest.raises(ValueError):
        tops.moe_gmm_ragged(torch.randn(96, 64, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            w[None], w[None], w[None], block_c=96)
    assert tops.LAUNCHES["swiglu_ffn"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grp,hd,bs,window", [(1, 64, 16, 0), (1, 64, 16, 40),
                                              (4, 128, 8, 0), (4, 128, 8, 27)])
def test_cuda_paged_attn_matches_plain(dtype, grp, hd, bs, window):
    """paged_attn_decode on fragmented tables, with rows sharing a lane,
    all-trash padding rows, a poisoned trash block and windows that mask
    whole leading blocks, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows, kh, depth = 6, 16 // grp // (2 if grp > 1 else 1), 75
    nblk = -(-(depth + 1) // bs)
    nblocks = rows * nblk + 1
    kp = torch.randn((nblocks, bs, kh, hd), generator=g, device=dev)
    vp = torch.randn((nblocks, bs, kh, hd), generator=g, device=dev)
    kp[0], vp[0] = 1e4, -1e4                     # poisoned trash block
    table = (torch.randperm(nblocks - 1, generator=g, device=dev) + 1)[
        :rows * nblk].reshape(rows, nblk).to(torch.int32)
    table[1] = table[0]                          # two rows share a lane
    table[5] = 0                                 # an all-trash padding row
    pos = torch.tensor([depth, depth - 5, 60, 33, depth, 0],
                       dtype=torch.int32, device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    tops.reset_launches()
    got = tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                 window=window, scale=hd ** -0.5)
    ref = paged_attn_decode_plain(q, kp, vp, table, pos, window,
                                  scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_attn_decode"] == 1
    assert torch.isfinite(got).all()
    # the real rows, and the all-trash row (reading the poisoned block),
    # each against a tolerance of its own scale
    for sl in (slice(0, 5), slice(5, 6)):
        tol = (1e-4 if dt == torch.float32 else 2e-2) * \
            ref[sl].float().abs().max().item()
        assert (got[sl].float() - ref[sl].float()).abs().max().item() <= tol


# (depth, pos of each row): the short view of one chunk (row 5 is an
# all-trash padding row); MLA_LONG's depth over three 1024-key chunks of the
# tensor-core route, pos at and around the chunk edges and -1
MLA_VIEWS = {"short": (45, [45, 40, 30, 17, 45, 0]),
             "chunks": (2048, [2048, 1023, 1024, 1025, 2047, 3, -1])}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,r,dr,bs", [(128, 512, 64, 16), (12, 96, 16, 8),
                                           (4, 32, 8, 4), (12, 512, 64, 16),
                                           (4, 512, 64, 8)])
@pytest.mark.parametrize("view", sorted(MLA_VIEWS))
def test_cuda_mla_paged_decode_matches_plain(dtype, heads, r, dr, bs, view):
    """mla_paged_decode on fragmented tables, with rows sharing a lane, a
    poisoned trash block and depths that are not a multiple of the block
    size, against its plain version, each row within the tolerance of its
    own scale: one chunk (with an all-trash padding row) and views of
    several chunks (pos at the chunk edges, a row whose keys fit the first
    chunk, pos -1). bfloat16 at r 512 / dr 64 runs the tensor cores, with
    12 and 4 heads padded in the M tile; each call runs one launch of the
    route mla_route names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import (MLA_ROUTE_LAUNCHES,
                                                     mla_paged_decode_plain,
                                                     mla_route)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    depth, at = MLA_VIEWS[view]
    rows = len(at)
    nblk = -(-(depth + 1) // bs)
    nblocks = rows * nblk + 1
    cc = torch.randn((nblocks, bs, r), generator=g, device=dev)
    cp = torch.randn((nblocks, bs, dr), generator=g, device=dev)
    cc[0], cp[0] = 1e4, -1e4                     # poisoned trash block
    table = (torch.randperm(nblocks - 1, generator=g, device=dev) + 1)[
        :rows * nblk].reshape(rows, nblk).to(torch.int32)
    table[1] = table[0]                          # two rows share a lane
    if view == "short":
        table[5] = 0                             # an all-trash padding row
    pos = torch.tensor(at, dtype=torch.int32, device=dev)
    qa = torch.randn((rows, heads, r), generator=g, device=dev)
    qp = torch.randn((rows, heads, dr), generator=g, device=dev)
    qa, qp, cc, cp = qa.to(dt), qp.to(dt), cc.to(dt), cp.to(dt)
    scale = (r // 4 + dr) ** -0.5
    tops.reset_launches()
    got = tops.mla_paged_decode(qa, qp, cc, cp, table=table, pos=pos,
                                scale=scale)
    ref = mla_paged_decode_plain(qa, qp, cc, cp, table, pos, scale=scale)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["mla_paged_decode"] == 1
    assert MLA_ROUTE_LAUNCHES == {mla_route(dt, r, dr): 1}
    assert got.dtype == dt and torch.isfinite(got).all()
    _close_rows(got, ref, dt)


@pytest.mark.cuda
def test_cuda_mla_rows_are_width_invariant():
    """A row's mla_paged_decode output is bitwise the same alone and inside
    a call of many rows (whose head groups differ on the tensor cores),
    through a paged table or the same lane held as a contiguous cache (a
    pool of one block per lane), and through a table wide enough that its
    view spans two chunks (the merge runs) where the contiguous one spans
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    rows, heads, r, dr, bs, nblk = 9, 128, 512, 64, 16, 5
    bf = torch.bfloat16
    cc = torch.randn((1 + rows * nblk, bs, r), generator=g, device=dev).to(bf)
    cp = torch.randn((1 + rows * nblk, bs, dr), generator=g,
                     device=dev).to(bf)
    table = (torch.randperm(rows * nblk, generator=g, device=dev) + 1
             ).reshape(rows, nblk).to(torch.int32)
    pos = torch.randint(0, nblk * bs, (rows,), generator=g, device=dev).to(
        torch.int32)
    qa = torch.randn((rows, heads, r), generator=g, device=dev).to(bf)
    qp = torch.randn((rows, heads, dr), generator=g, device=dev).to(bf)
    whole = tops.mla_paged_decode(qa, qp, cc, cp, table=table, pos=pos,
                                  scale=0.07)
    lanes_c = cc[table.long()].reshape(rows, nblk * bs, r)
    lanes_p = cp[table.long()].reshape(rows, nblk * bs, dr)
    lane_table = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    for i in (0, 4, rows - 1):
        one = tops.mla_paged_decode(qa[i:i + 1], qp[i:i + 1], cc, cp,
                                    table=table[i:i + 1], pos=pos[i:i + 1],
                                    scale=0.07)
        assert torch.equal(one, whole[i:i + 1])
    contiguous = tops.mla_paged_decode(qa, qp, lanes_c, lanes_p,
                                       table=lane_table, pos=pos, scale=0.07)
    assert torch.equal(contiguous, whole)
    # 8 copies of the call: 72 rows fill the card with head groups of 64
    # where 9 rows (and a row alone) take groups of 16 in the same M tile
    big = tops.mla_paged_decode(qa.repeat(8, 1, 1), qp.repeat(8, 1, 1), cc,
                                cp, table=table.repeat(8, 1),
                                pos=pos.repeat(8), scale=0.07)
    assert torch.equal(big[-rows:], whole)
    # a table of 70 blocks: the paged view spans two chunks of the
    # tensor-core route (its merge runs, over one live chunk) where the
    # contiguous view spans one
    from repro_torch.kernels.common import MLA_CHUNK
    wide_table = torch.cat([table, table.new_zeros((rows, 65))], dim=1)
    assert wide_table.shape[1] * bs > MLA_CHUNK >= nblk * bs
    for i in (2, rows - 1):
        wide = tops.mla_paged_decode(qa[i:i + 1], qp[i:i + 1], cc, cp,
                                     table=wide_table[i:i + 1],
                                     pos=pos[i:i + 1], scale=0.07)
        assert torch.equal(wide, contiguous[i:i + 1])


def _pools(g, dev, dt, rows, depth, bs, width):
    """Pools of `width` channels a key (a trailing (kh, hd) for GQA, (r,)
    or (dr,) for MLA) holding `rows` lanes of depth + 1 keys in fragmented
    blocks, block 0 poisoned trash; returns (pool, pool, table)."""
    nblk = -(-(depth + 1) // bs)
    nblocks = rows * nblk + 1
    a = torch.randn((nblocks, bs, *width), generator=g, device=dev)
    b = torch.randn((nblocks, bs, *width), generator=g, device=dev)
    a[0], b[0] = 1e4, -1e4
    table = (torch.randperm(nblocks - 1, generator=g, device=dev) + 1
             ).reshape(rows, nblk).to(torch.int32)
    return a.to(dt), b.to(dt), table


def _close_rows(got, ref, dt):
    """Each row against a tolerance of its own scale (a masked row is the
    small mean of its view)."""
    for i in range(got.shape[0]):
        _close(got[i], ref[i], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,bs,window", [(75, 16, 0), (75, 16, 30),
                                             (700, 16, 0), (700, 8, 100)])
def test_cuda_paged_kernels_match_plain_at_negative_pos(dtype, depth, bs,
                                                        window):
    """A row at pos -1 masks every key of its view: both paged kernels
    return the uniform average of the view's V (latent) rows, as their
    plain versions and ref.py do, beside rows at pos >= 0 in the same
    call; views of one and of several 256-key chunks, and windows (which
    mask nothing more there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import (mla_paged_decode_plain,
                                                     paged_attn_decode_plain)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rows, kh, grp, hd = 4, 2, 2, 64
    kp, vp, table = _pools(g, dev, dt, rows, depth, bs, (kh, hd))
    pos = torch.tensor([depth, -1, depth // 2, -1], dtype=torch.int32,
                       device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev).to(dt)
    tops.reset_launches()
    got = tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                 window=window, scale=hd ** -0.5)
    ref = paged_attn_decode_plain(q, kp, vp, table, pos, window,
                                  scale=hd ** -0.5)
    heads, r, dr = 16, 64, 16
    cc, _, mtable = _pools(g, dev, dt, rows, depth, bs, (r,))
    cp, _, _ = _pools(g, dev, dt, rows, depth, bs, (dr,))
    cp = cp[:cc.shape[0]]
    qa = torch.randn((rows, heads, r), generator=g, device=dev).to(dt)
    qp = torch.randn((rows, heads, dr), generator=g, device=dev).to(dt)
    got_m = tops.mla_paged_decode(qa, qp, cc, cp, table=mtable, pos=pos,
                                  scale=0.1)
    ref_m = mla_paged_decode_plain(qa, qp, cc, cp, mtable, pos, scale=0.1)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_attn_decode"] == 1
    assert tops.LAUNCHES["mla_paged_decode"] == 1
    _close_rows(got, ref, dt)
    _close_rows(got_m, ref_m, dt)
    assert got[1].float().abs().max() > 0     # not the zeros of old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attn_rows_are_bitwise_invariant(dtype):
    """A row's paged_attn_decode output is bitwise the same alone and inside
    a call of many rows, through a paged table, the same lane held as a
    contiguous cache (a pool of one block per lane) or re-blocked by 8, and
    through a table wider by trailing trash entries or narrow enough for
    one 256-key chunk (the merge then does not run); at pos just below, at
    and past the chunk edges, with and without a window; and run to run.
    Every row has pos >= 0: at pos < 0 the view itself is the function's
    input."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rows, kh, grp, hd, bs, nblk = 12, 4, 2, 64, 16, 40      # view 640
    kp, vp, table = _pools(g, dev, dt, rows, nblk * bs - 1, bs, (kh, hd))
    pos = torch.tensor([0, 254, 255, 256, 257, 511, 512, 513, 639, 100,
                        300, 600], dtype=torch.int32, device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev).to(dt)
    lanes_k = kp[table.long()].reshape(rows, 1, nblk * bs, kh, hd)
    lanes_v = vp[table.long()].reshape(rows, 1, nblk * bs, kh, hd)
    lane_table = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    by8_table = torch.arange(rows * nblk * 2, dtype=torch.int32,
                             device=dev).reshape(rows, -1)
    wide = torch.cat([table, table.new_zeros((rows, 20))], 1)
    short = pos < 256

    def call(q, kp, vp, table, pos, window):
        return tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                      window=window, scale=hd ** -0.5)

    for window in (0, 200):
        whole = call(q, kp, vp, table, pos, window)
        assert torch.equal(whole, call(q, kp, vp, table, pos, window))
        for i in range(rows):
            assert torch.equal(whole[i:i + 1],
                               call(q[i:i + 1], kp, vp, table[i:i + 1],
                                    pos[i:i + 1], window))
        assert torch.equal(whole, call(q, lanes_k[:, 0], lanes_v[:, 0],
                                       lane_table, pos, window))
        assert torch.equal(whole, call(
            q, lanes_k.reshape(-1, 8, kh, hd), lanes_v.reshape(-1, 8, kh, hd),
            by8_table, pos, window))
        assert torch.equal(whole, call(q, kp, vp, wide, pos, window))
        assert torch.equal(whole[short], call(
            q[short], kp, vp, table[short][:, :256 // bs].contiguous(),
            pos[short], window))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,grp,hd,depth,window",
                         [(2, 48, 128, 300, 0), (1, 48, 128, 700, 0),
                          (2, 1, 256, 900, 0), (4, 1, 64, 1000, 300),
                          (2, 3, 96, 600, 520), (2, 8, 256, 400, 0)])
def test_cuda_paged_attn_long_views_match_plain(dtype, kh, grp, hd, depth,
                                               window):
    """paged_attn_decode over views of several 256-key chunks against its
    plain version: granite's 48 query heads per kv head of 128 (once
    refused: grp x hd past 2048), hd 256, windows that kill the leading
    chunks, a group of 3 and hd 96 (lanes and heads left idle)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    rows = 4
    kp, vp, table = _pools(g, dev, dt, rows, depth, 16, (kh, hd))
    pos = torch.tensor([depth, depth - 1, depth // 2, 5], dtype=torch.int32,
                       device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev).to(dt)
    tops.reset_launches()
    got = tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                 window=window, scale=hd ** -0.5)
    ref = paged_attn_decode_plain(q, kp, vp, table, pos, window,
                                  scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_attn_decode"] == 1
    assert got.shape == q.shape and got.dtype == dt
    _close_rows(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_rows_are_bitwise_invariant(dtype):
    """flash_decode on its split route: a row is bitwise the same alone and
    in a call, and through a cache of 1100 keys (5 chunks, merged) or cut to
    200 (one chunk, no merge) when pos leaves one chunk live."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((6, 1, 128), (6, 1100, 128), (6, 1100, 128)))
    for pos in (100, 255, 700):
        whole = tops.flash_decode(q, k, v, pos)
        assert torch.equal(whole, tops.flash_decode(q, k, v, pos))
        assert torch.equal(whole[2:3], tops.flash_decode(
            q[2:3], k[2:3].contiguous(), v[2:3].contiguous(), pos))
        if pos < 200:
            assert torch.equal(whole, tops.flash_decode(
                q, k[:, :200].contiguous(), v[:, :200].contiguous(), pos))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1024, 1024), (5120, 1536)])
def test_cuda_row_matmul_is_width_invariant(dtype, k, n):
    """A row's product is bitwise the same alone and inside a call of any
    width, below the probed row count (one call where the probe allows it)
    and above it (row tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (cuBLAS products)")
    from repro_torch.models.layers import PROBE_ROWS, matmul
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    dt = getattr(torch, dtype)
    w = (torch.randn((k, n), generator=g, device=dev) * k ** -0.5).to(dt)
    x = torch.randn((PROBE_ROWS + 72, k), generator=g, device=dev).to(dt)
    for width in (1, 3, 64, 65, PROBE_ROWS, PROBE_ROWS + 1, PROBE_ROWS + 72):
        y = matmul(x[:width], w)
        for row in {0, width - 1}:
            assert torch.equal(y[row:row + 1], matmul(x[row:row + 1], w))


def _ssd_case(g, dev, dtype, b, s, nh, hp, n, state, slow=False):
    """ssd_scan operands as the model hands them: xh, B and C are views of
    one conv output (batch and sequence strides over di + 2N channels), dt
    post-softplus in float32, and h0 random or None. slow: dt ~ U(0.001,
    0.05) and A ~ -U(0.1, 1), so that a 64-row chunk keeps a visible part
    (exp(l_end) ~ 0.4) of the state it starts from; the default decay
    keeps ~1e-5 of it at most, under the tolerance."""
    di = nh * hp
    conv = torch.randn((b, s, di + 2 * n), generator=g, device=dev).to(dtype)
    xh = conv[..., :di].reshape(b, s, nh, hp)
    bm, cm = conv[..., di:di + n], conv[..., di + n:]
    if slow:
        dt = 0.001 + 0.049 * torch.rand((b, s, nh), generator=g, device=dev)
        a_log = torch.log(0.1 + 0.9 * torch.rand((nh,), generator=g,
                                                 device=dev))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, nh), generator=g, device=dev) - 1.0)
        a_log = 0.3 * torch.randn((nh,), generator=g, device=dev)
    d_skip = torch.randn((nh,), generator=g, device=dev)
    h0 = torch.randn((b, nh, hp, n), generator=g, device=dev) \
        if state else None
    return xh, dt, bm, cm, a_log, d_skip, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hp,n,state,slow", [
    (4, 32, 32, 64, 128, False, False),    # mamba2-370m's prefill, fresh
    (4, 32, 32, 64, 128, True, False),     # the same from a carried state
    (3, 100, 8, 64, 128, True, False),     # not a multiple of the chunk
    (2, 2048, 32, 64, 128, False, False),  # a long forward
    (2, 96, 64, 64, 64, True, False),      # zamba2-1.2b's widths
    (2, 2048, 32, 64, 128, True, False),   # many chunks from a random state
    (2, 1000, 32, 64, 128, True, False),   # a ragged multi-chunk length
    (1, 1024, 64, 64, 64, True, False),    # zamba2's widths, many chunks
    (2, 1, 32, 64, 128, False, False),     # one row, no state
    (2, 5, 32, 64, 128, False, False),     # five rows, no state
    (2, 2048, 32, 64, 128, True, True),    # many chunks, the carry kept
    (2, 1000, 32, 64, 128, True, True),    # ragged, the carry kept
    (1, 1024, 64, 64, 64, True, True)])    # zamba2's widths, carry kept
def test_cuda_ssd_scan_matches_plain(dtype, b, s, nh, hp, n, state, slow):
    """ssd_scan on strided views of one conv output against its plain
    version at the config's chunk of 256: |err| <= 1e-4 max|ref| for y and
    h_fin (fp32 arithmetic on the same values in both types, chunked
    differently); one launch counted per call, whichever of the kernels'
    one or three passes it runs. The slow cases decay little over a chunk,
    so a state lost between chunks would show."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    args = _ssd_case(g, dev, getattr(torch, dtype), b, s, nh, hp, n, state,
                     slow)
    tops.reset_launches()
    y, h = tops.ssd_scan(*args[:6], chunk=256, h0=args[6])
    y_ref, h_ref = ssd_scan_plain(*args[:6], 256, h0=args[6])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["ssd_scan"] == 1
    for got, ref in ((y, y_ref), (h, h_ref)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        tol = 1e-4 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,hp,n", [
    (4, 32, 32, 64, 128),            # one chunk: chunk_out alone
    (2, 1000, 32, 64, 128)])         # three passes over one workspace
def test_cuda_ssd_scan_graph_replay_is_bitwise(b, s, nh, hp, n):
    """Two eager calls give the same bits, and so does the call captured
    in a CUDA graph and replayed: no host synchronisation, no allocation
    in the kernels, no order that changes from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    args = _ssd_case(g, dev, torch.bfloat16, b, s, nh, hp, n, True)

    def call():
        return tops.ssd_scan(*args[:6], chunk=256, h0=args[6])

    first, second = call(), call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    for got in (second, captured):
        assert all(torch.equal(x, r) for x, r in zip(got, first))


@pytest.mark.cuda
def test_cuda_ssd_scan_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    xh, dt, bm, cm, a_log, d_skip, _ = _ssd_case(g, dev, torch.float32, 2,
                                                 8, 4, 16, 32, False)
    with pytest.raises(TypeError):
        tops.ssd_scan(xh, dt, bm.bfloat16(), cm, a_log, d_skip)
    with pytest.raises(ValueError):
        tops.ssd_scan(xh, dt.double(), bm, cm, a_log, d_skip)
    with pytest.raises(ValueError):
        tops.ssd_scan(xh, dt, bm, cm, a_log, d_skip,
                      h0=torch.zeros((2, 4, 16, 32)))   # h0 on the CPU
    with pytest.raises(ValueError):                   # over shared memory
        big = torch.zeros((1, 4, 1, 256), device=dev)
        tops.ssd_scan(big, torch.ones((1, 4, 1), device=dev),
                      torch.zeros((1, 4, 512), device=dev),
                      torch.zeros((1, 4, 512), device=dev),
                      torch.zeros(1, device=dev), torch.ones(1, device=dev))


def _close(got, ref, dt):
    tol = (1e-4 if dt == torch.float32 else 2e-2) * \
        ref.float().abs().max().item()
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,m,act", [
    (160, 8, 512, 96, "swiglu"),     # deepseek-v2's expert count, C = 8
    (5, 1, 96, 72, "swiglu"),        # C = 1
    (3, 70, 96, 200, "geglu"),       # C and m not multiples of the tile
    (2, 128, 64, 64, "swiglu")])     # two full row tiles per expert
def test_cuda_moe_gmm_matches_plain(dtype, e, c, d, m, act):
    """moe_gmm over dense (E, C, d) buffers against its plain version, no
    padding of C or m; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(8)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    xbuf = rnd((e, c, d))
    wg, wu = rnd((e, d, m), d ** -0.5), rnd((e, d, m), d ** -0.5)
    wd = rnd((e, m, d), m ** -0.5)
    tops.reset_launches()
    got = tops.moe_gmm(xbuf, wg, wu, wd, activation=act)
    ref = moe_gmm_plain(xbuf, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["moe_gmm"] == 1
    assert got.shape == (e, c, d) and got.dtype == dt
    _close(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,nr,act", [
    (4, 1024, 5, "swiglu"),          # qwen1.5-0.5b converted, decode
    (512, 1024, 5, "swiglu"),        # qwen1.5-0.5b, the calibration batch
    (128, 4096, 13, "swiglu"),       # llama2-7b's widest router
    (100, 4096, 5, "geglu"),         # T not a multiple of any block
    (1, 1024, 5, "swiglu"),          # one row: one block of one live warp
    (100, 1024, 13, "geglu"),        # ragged T, the weights staged whole
    (5000, 1024, 5, "swiglu"),       # two rows a warp (1056 blocks)
    (4500, 4096, 13, "swiglu")])     # two rows a warp, weights in chunks
def test_cuda_router_score_matches_plain(dtype, t, d, nr, act):
    """router_score against its plain version (f32 out, g and u unrounded)
    over router_score.plan's grids: one row a warp, several, the weights
    staged whole or in chunks of d; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.router_score import router_score_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    x = torch.randn((t, d), generator=g, device=dev).to(dt)
    wg = (torch.randn((d, nr), generator=g, device=dev) * d ** -0.5).to(dt)
    wu = (torch.randn((d, nr), generator=g, device=dev) * d ** -0.5).to(dt)
    tops.reset_launches()
    got = tops.router_score(x, wg, wu, activation=act)
    ref = router_score_plain(x, wg, wu, act)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["router_score"] == 1
    assert got.shape == (t, nr) and got.dtype == torch.float32
    _close(got, ref, dt)


@pytest.mark.cuda
def test_cuda_moe_gmm_and_router_score_reject_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    xb = torch.randn(2, 4, 32, device=dev)
    w = torch.randn(2, 32, 32, device=dev)
    with pytest.raises(ValueError):                   # a bank of E = 3
        tops.moe_gmm(xb, torch.randn(3, 32, 32, device=dev), w, w)
    with pytest.raises(TypeError):
        tops.moe_gmm(xb, w, w, w.bfloat16())
    x = torch.randn(8, 32, device=dev)
    with pytest.raises(ValueError):                   # 17 router columns
        wide = torch.randn(32, 17, device=dev)
        tops.router_score(x, wide, wide)
    with pytest.raises(ValueError):
        tops.router_score(x, torch.randn(32, 5), torch.randn(32, 5))


# (BH, S, T, D, causal): S and T not multiples of the 64 x 32 tiles, the
# causal S > T case (queries past T see every key), a non-causal ragged T,
# gemma3's D 256, a D the 16-byte loads cannot take, and a tiny call
FLASH_ATTN_CASES = [(3, 100, 100, 16, True), (2, 64, 50, 64, True),
                    (2, 100, 50, 128, True), (2, 70, 45, 128, False),
                    (1, 130, 130, 256, True), (2, 33, 40, 100, False),
                    (2, 5, 9, 3, True)]
# bf16 runs these on the tensor cores (128-row q tiles, 128-key K/V tiles at
# D 64 and 128, 64 at D 256): S and T off both tiles, causal S > T and S <
# T, a non-causal ragged T, S = 1, T = 1; and 264 x 2 blocks, four waves
FLASH_ATTN_CASES += [(bh, s, t, d, causal) for d in (64, 128, 256)
                     for bh, s, t, causal in
                     [(2, 300, 190, True), (2, 150, 333, True),
                      (2, 200, 259, False), (3, 1, 77, False),
                      (3, 77, 1, True)]] + [(264, 130, 130, 128, True)]
# (BH, T, D, pos): the reference test's shapes, pos at and past T, a
# negative pos (every key masked: the oracle's uniform average), D 256;
# views of several 256-key chunks (phase 7's T 1100, pos at and around the
# chunk edges, a negative pos over 3 chunks, a full 4096 cache at BH 128),
# and D 6 (the SIMT route in both dtypes; bf16 D 100 too)
FLASH_DECODE_CASES = [(4, 100, 32, 63), (2, 512, 64, 511), (3, 70, 16, 0),
                      (1, 33, 8, 20), (2, 100, 128, 120), (2, 100, 128, 99),
                      (2, 40, 64, -1), (2, 300, 256, 200), (3, 45, 100, 30)]
FLASH_DECODE_CASES += [(4, 1100, 128, 1024), (3, 777, 64, 255),
                       (3, 777, 64, 256), (3, 777, 64, 513),
                       (2, 600, 256, -1), (128, 4096, 128, 4095),
                       (2, 45, 6, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,t,d,causal", FLASH_ATTN_CASES)
def test_cuda_flash_attention_matches_plain(dtype, bh, s, t, d, causal):
    """flash_attention against its plain version (ref.flash_attention_ref's
    function, top-left causal mask); one launch counted per call, on the
    kernel that ``route`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES,
                                                     flash_attention_plain,
                                                     route)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))
    tops.reset_launches()
    ROUTE_LAUNCHES.clear()
    got = tops.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == 1
    assert ROUTE_LAUNCHES == {route(dt, d): 1}
    assert got.shape == (bh, s, d) and got.dtype == dt
    _close(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d,pos", FLASH_DECODE_CASES)
def test_cuda_flash_decode_matches_plain(dtype, bh, t, d, pos):
    """flash_decode against its plain version (ref.flash_decode_ref's
    function: no padded keys, so pos >= T attends exactly the T keys); pos
    handed over as an int and as a device tensor; one launch a call, on
    the kernel that ``route`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.flash_decode import (ROUTE_LAUNCHES,
                                                  flash_decode_plain, route)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((bh, 1, d), (bh, t, d), (bh, t, d)))
    tops.reset_launches()
    got = tops.flash_decode(q, k, v, pos)
    again = tops.flash_decode(q, k, v, torch.tensor(pos, device=dev))
    ref = flash_decode_plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_decode"] == 2
    assert ROUTE_LAUNCHES == {route(dt, d): 2}
    assert got.shape == (bh, 1, d) and got.dtype == dt
    assert torch.equal(got, again)
    _close(got, ref, dt)


@pytest.mark.cuda
def test_cuda_flash_pair_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    q = torch.randn(2, 8, 64, device=dev)
    with pytest.raises(ValueError):                   # D past 256
        wide = torch.randn(2, 8, 300, device=dev)
        tops.flash_attention(wide, wide, wide)
    with pytest.raises(TypeError):
        tops.flash_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError):                   # k and v differ
        tops.flash_attention(q, q, q[:, :4].contiguous())
    with pytest.raises(ValueError):                   # two queries a row
        tops.flash_decode(q[:, :2].contiguous(), q, q, 3)
    with pytest.raises(ValueError):                   # v on the CPU
        tops.flash_decode(q[:, :1].contiguous(), q, q.cpu(), 3)


def _bf16_case(g, dev, *shapes):
    """bf16 operands of the given shapes, each scaled by its fan-in (the
    second-to-last dim; 1 for the first, the input)."""
    return [(torch.randn(s, generator=g, device=dev) *
             (s[-2] ** -0.5 if i else 1.0)).to(torch.bfloat16)
            for i, s in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 100, 512])
@pytest.mark.parametrize("d,f", [(1024, 2816), (2048, 8192)])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_cuda_swiglu_ffn_tensor_cores_match_plain(t, d, f, act):
    """swiglu_ffn's bfloat16 route at qwen1.5-0.5b's and zamba2-1.2b's
    widths, T on and off the 64-row tile: each call on the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.swiglu import ROUTE_LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    x, wg, wu, wd = _bf16_case(g, dev, (t, d), (d, f), (d, f), (f, d))
    tops.reset_launches()
    got = tops.swiglu_ffn(x, wg, wu, wd, activation=act)
    ref = swiglu_ffn_plain(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["swiglu_ffn"] == 1
    assert ROUTE_LAUNCHES == {"tensor_core": 1}
    assert got.shape == (t, d) and got.dtype == torch.bfloat16
    _close(got, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 70, 130])
@pytest.mark.parametrize("e,d,m", [(8, 1024, 352), (8, 5120, 1536)])
def test_cuda_moe_gmm_tensor_cores_match_plain(c, e, d, m):
    """moe_gmm's bfloat16 route at qwen1.5-0.5b's converted expert width
    and deepseek-v2's (whose down stage takes 128-wide column tiles), C on
    and off the 64-row tile: each call on the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.moe_gmm import ROUTE_LAUNCHES, moe_gmm_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    act = "geglu" if c == 70 else "swiglu"
    xbuf, wg, wu, wd = _bf16_case(g, dev, (e, c, d), (e, d, m), (e, d, m),
                                  (e, m, d))
    tops.reset_launches()
    got = tops.moe_gmm(xbuf, wg, wu, wd, activation=act)
    ref = moe_gmm_plain(xbuf, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES == {"tensor_core": 1}
    assert got.shape == (e, c, d) and got.dtype == torch.bfloat16
    _close(got, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_and_router_clone_misaligned_views(dtype):
    """mla_paged_decode's and router_score's 16-byte copies take a
    contiguous view whose base is off the 16-byte grid: the wrapper copies
    it, and the result matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import (MLA_ROUTE_LAUNCHES,
                                                     mla_paged_decode_plain,
                                                     mla_route)
    from repro_torch.kernels.router_score import router_score_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(15)

    def off_grid(shape):
        n = 1
        for k in shape:
            n *= k
        flat = torch.randn((n + 1,), generator=g, device=dev).to(dt)
        return flat[1:].view(shape)              # one element off the grid

    rows, heads, r, dr, bs, depth = 3, 16, 512, 64, 16, 70
    cc, cp, table = off_grid((6 * 3 + 1, bs, r)), off_grid((19, bs, dr)), \
        (torch.randperm(18, generator=g, device=dev) + 1).reshape(
            3, 6).to(torch.int32)
    qa, qp = off_grid((rows, heads, r)), off_grid((rows, heads, dr))
    pos = torch.tensor([depth, 20, -1], dtype=torch.int32, device=dev)
    assert all(t.data_ptr() % 16 for t in (qa, qp, cc, cp))
    tops.reset_launches()
    got = tops.mla_paged_decode(qa, qp, cc, cp, table=table, pos=pos,
                                scale=0.1)
    _close_rows(got, mla_paged_decode_plain(qa, qp, cc, cp, table, pos,
                                            scale=0.1), dt)
    x, w, u = off_grid((37, 1024)), off_grid((1024, 5)), off_grid((1024, 5))
    _close(tops.router_score(x, w, u), router_score_plain(x, w, u), dt)
    torch.cuda.synchronize()
    assert MLA_ROUTE_LAUNCHES == {mla_route(dt, r, dr): 1}
    assert tops.LAUNCHES["router_score"] == 1


@pytest.mark.cuda
def test_cuda_ffn_tensor_cores_clone_misaligned_views():
    """A contiguous view whose base is off the 16-byte grid TMA needs is
    copied by the wrapper, not refused and not sent to the SIMT core."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels import moe_gmm, swiglu
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    t, d, f = 37, 256, 192
    x, wg, wu, wd = _bf16_case(g, dev, (t * d + 1,), (d, f), (d, f), (f, d))
    x = x[1:].view(t, d)                             # 2 bytes off the grid
    wd = torch.cat([wd.flatten()[:3], wd.flatten()])[3:].view(f, d)
    assert x.data_ptr() % 16 and wd.data_ptr() % 16
    tops.reset_launches()
    _close(tops.swiglu_ffn(x, wg, wu, wd),
           swiglu.swiglu_ffn_plain(x, wg, wu, wd), torch.bfloat16)
    xbuf = x[:36].view(4, 9, d)                      # E 4, C 9, off the grid
    bg, bu, bd = (a[None].expand(4, -1, -1).contiguous() for a in (wg, wu, wd))
    bd = torch.cat([bd.flatten()[:1], bd.flatten()])[1:].view(bd.shape)
    assert xbuf.data_ptr() % 16 and bd.data_ptr() % 16
    _close(tops.moe_gmm(xbuf, bg, bu, bd),
           moe_gmm.moe_gmm_plain(xbuf, bg, bu, bd), torch.bfloat16)
    torch.cuda.synchronize()
    assert swiglu.ROUTE_LAUNCHES == {"tensor_core": 1}
    assert moe_gmm.ROUTE_LAUNCHES == {"tensor_core": 1}


@pytest.mark.cuda
def test_cuda_ffn_tensor_cores_are_row_invariant():
    """A row's result on the tensor cores does not depend on the other
    rows of the call, bitwise: swiglu_ffn's rows alone against the same
    rows inside T = 512 (and T = 100); moe_gmm at C = 1 against C = 8 and C
    = 70, at qwen's converted and deepseek-v2's expert widths. Past 64 rows
    an expert's gate/up blocks hold two warpgroups, so T 100 and 512 and C
    70 cross that switch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    d, f = 1024, 2816
    x, wg, wu, wd = _bf16_case(g, dev, (512, d), (d, f), (d, f), (f, d))
    full = tops.swiglu_ffn(x, wg, wu, wd)
    assert torch.equal(tops.swiglu_ffn(x[:100], wg, wu, wd), full[:100])
    for r in (0, 1, 63, 64, 300, 511):
        assert torch.equal(tops.swiglu_ffn(x[r:r + 1], wg, wu, wd),
                           full[r:r + 1]), r
    for e, d, m in ((8, 1024, 352), (8, 5120, 1536)):
        xbuf, bg, bu, bd = _bf16_case(g, dev, (e, 70, d), (e, d, m),
                                      (e, d, m), (e, m, d))
        full = tops.moe_gmm(xbuf, bg, bu, bd)
        assert torch.equal(tops.moe_gmm(xbuf[:, :8].contiguous(), bg, bu,
                                        bd), full[:, :8])
        for c in (0, 3, 7, 69):
            one = tops.moe_gmm(xbuf[:, c:c + 1].contiguous(), bg, bu, bd)
            assert torch.equal(one, full[:, c:c + 1]), (d, c)
    torch.cuda.synchronize()


def _routed_case(g, dev, t, k, e, d, m):
    """bf16 tokens (t, d), banks (e, d, m) x 2 and (e, m, d), and (t, k)
    expert ids, distinct within each token (top-k of random scores)."""
    x, wg, wu, wd = _bf16_case(g, dev, (t, d), (e, d, m), (e, d, m),
                               (e, m, d))
    idx = torch.rand((t, e), generator=g, device=dev).topk(k, dim=1).indices
    return x, idx, [wg, wu, wd]


def _ragged_rows(x, idx, bank, act="swiglu"):
    """moe_gmm_ragged's output row of each (token, expert) pair, in flat
    assignment order, and the whole layout's output with its live mask."""
    from repro_torch.core.experts import ragged_layout, ragged_scatter
    t, k = idx.shape
    slot, owner, _, p_total = ragged_layout(idx.reshape(-1), bank[0].shape[0],
                                            64)
    xp = ragged_scatter(x, k, slot, p_total)
    yp = tops.moe_gmm_ragged(xp, owner, *bank, activation=act, block_c=64)
    live = torch.zeros(p_total, dtype=torch.bool, device=x.device)
    live[slot] = True
    return yp[slot], yp, xp, owner, live


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,e,d,m,act", [
    (128, 3, 5, 1024, 352, "swiglu"),   # qwen's converted experts, prefill
    (100, 2, 2, 96, 72, "geglu"),       # 100 rows an expert: two tiles each
    (40, 6, 160, 128, 256, "swiglu")])  # 160 experts: BN 128 up, 64 down
def test_cuda_moe_gmm_ragged_tensor_cores_match_plain(t, k, e, d, m, act):
    """moe_gmm_ragged's bfloat16 route over layouts with padding rows, an
    expert of more than 64 rows and trailing tiles (owner E - 1, all zero
    rows), on both sides of the BN switch: each call on the tensor cores,
    every row that holds no assignment exactly zero, and a tile whose
    owner is out of range exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.moe_gmm import RAGGED_ROUTE_LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    x, idx, bank = _routed_case(g, dev, t, k, e, d, m)
    tops.reset_launches()
    _, got, xp, owner, live = _ragged_rows(x, idx, bank, act)
    ref = moe_gmm_ragged_plain(xp, owner, *bank, act, 64)
    torch.cuda.synchronize()
    assert RAGGED_ROUTE_LAUNCHES == {"tensor_core": 1}
    assert got.shape == xp.shape and got.dtype == torch.bfloat16
    _close(got, ref, torch.bfloat16)
    assert not got[~live].any()
    # the layout's worst-case extent leaves at least one trailing tile
    assert int(live.nonzero().max()) < xp.shape[0] - 64
    bad = owner.clone()
    bad[0] = e
    out = tops.moe_gmm_ragged(xp, bad, *bank, activation=act, block_c=64)
    assert not out[:64].any() and torch.equal(out[64:], got[64:])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,e,d,m,act", [
    (4, 3, 5, 1024, 352, "swiglu"),     # qwen's decode step
    (100, 2, 2, 96, 72, "geglu"),       # 100 rows an expert: runs of 64
    (26, 6, 160, 128, 256, "swiglu")])  # deepseek's widest mixed step
def test_cuda_moe_gather_tensor_cores_match_plain(t, k, e, d, m, act):
    """moe_gather's bfloat16 route with sentinel rows (exact zeros), more
    than 64 rows of one expert, and both sides of the BN switch: each call
    on the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.moe_gather import ROUTE_LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    x, idx, bank = _routed_case(g, dev, t, k, e, d, m)
    flat = idx.reshape(-1).to(torch.int32)
    flat[3::5] = e                                # sentinels
    tops.reset_launches()
    got = tops.moe_gather(x, flat, *bank, top_k=k, activation=act)
    ref = moe_gather_plain(x, flat, *bank, top_k=k, activation=act)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["moe_gather"] == 1
    assert ROUTE_LAUNCHES == {"tensor_core": 1}
    assert got.shape == (t * k, d) and got.dtype == torch.bfloat16
    _close(got, ref, torch.bfloat16)
    assert not got[flat == e].any()


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,e,d,m", [(100, 3, 5, 1024, 352),
                                       (26, 6, 160, 128, 256)])
def test_cuda_routed_rows_are_bitwise_equal_across_kernels(t, k, e, d, m):
    """On the tensor cores a (token, expert) pair's output row is bitwise
    the same through moe_gather, moe_gmm_ragged and moe_gmm's capacity
    buffers, alone or among the other tokens; so routed_experts' gather
    and grouped_kernel backends agree bitwise, which the engine's overlap
    parity stands on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from types import SimpleNamespace

    from repro_torch.core.experts import assign_positions, routed_experts
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    x, idx, bank = _routed_case(g, dev, t, k, e, d, m)
    flat = idx.reshape(-1)
    gathered = tops.moe_gather(x, flat, *bank, top_k=k)
    ragged, *_ = _ragged_rows(x, idx, bank)
    pos, keep = assign_positions(idx, e, t)
    xbuf = torch.zeros((e, t, d), dtype=x.dtype, device=dev)
    xbuf[flat, pos.reshape(-1)] = x.repeat_interleave(k, dim=0)
    capacity = tops.moe_gmm(xbuf, *bank)[flat, pos.reshape(-1)]
    assert torch.equal(gathered, ragged)
    assert torch.equal(gathered, capacity)
    for r in (0, t // 2, t - 1):
        one = idx[r:r + 1]
        assert torch.equal(tops.moe_gather(x[r:r + 1], one.reshape(-1), *bank,
                                           top_k=k), gathered[r * k:r * k + k])
        assert torch.equal(_ragged_rows(x[r:r + 1], one, bank)[0],
                           gathered[r * k:r * k + k])
    cfg = SimpleNamespace(activation="swiglu", cmoe=None, moe=None)
    gates = torch.rand((t, k), generator=g, device=dev)
    weights = dict(zip(("wg", "wu", "wd"), bank))
    outs = [routed_experts(x, weights, gates, idx, cfg, backend=b,
                           use_kernel=True)[0]
            for b in ("gather", "grouped_kernel")]
    assert torch.equal(outs[0], outs[1])
    torch.cuda.synchronize()


def _hier_case(g, dev, dtype, *, d=1024, e=16, k=4, m=64, n_s=3, n_r=5,
               k_sub=3):
    """A hierarchical (converted MoE) block at a medium width: the top
    level's router, balance bias and 2 shared experts, and per expert n_s
    shared sub-experts and n_r routed ones of m neurons with a sub-router,
    a sub-level bias and u. Returns (cfg, block params)."""
    from types import SimpleNamespace

    from repro_torch.config import CMoEConfig, MoEConfig
    dt = getattr(torch, dtype)

    def w(*shape, fan_in=None):
        fan = fan_in if fan_in is not None else shape[-2]
        return (torch.randn(shape, generator=g, device=dev) *
                fan ** -0.5).to(dt)

    def small(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    ms, ds = n_s * m, 2 * m
    cfg = SimpleNamespace(
        name="hierarchical-medium", activation="swiglu",
        moe=MoEConfig(num_experts=e, top_k=k, d_expert=(n_s + n_r) * m,
                      num_shared=2, d_shared=ds),
        cmoe=CMoEConfig(num_experts=n_s + n_r, num_shared=n_s, top_k=k_sub))
    p = {"moe": {"router": w(d, e), "balance_bias": small(e, scale=0.05),
                 "shared_wg": w(d, ds), "shared_wu": w(d, ds),
                 "shared_wd": w(ds, d)},
         "cmoe": {"shared": {"wg": w(e, d, ms), "wu": w(e, d, ms),
                             "wd": w(e, ms, d)},
                  "routed": {"wg": w(e, n_r, d, m), "wu": w(e, n_r, d, m),
                             "wd": w(e, n_r, m, d)},
                  "router": {"wg_r": w(e, d, n_r), "wu_r": w(e, d, n_r)},
                  "u": small(e, n_r, scale=0.5),
                  "bias": small(e, n_r, scale=0.05)}}
    return cfg, p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase,b,s", [("prefill", 4, 32), ("decode", 4, 1),
                                       ("mixed", 26, 1)])
def test_cuda_hierarchical_ffn_matches_plain(dtype, phase, b, s):
    """hierarchical_moe_ffn on the kernel path (moe_gmm_ragged at prefill
    and on fused steps, moe_gather at decode) against its plain path at a
    medium width, with a masked row and sub-level tiers below K_max."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.core.hierarchical import hierarchical_moe_ffn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    cfg, p = _hier_case(g, dev, dtype)
    x = torch.randn((b, s, 1024), generator=g, device=dev).to(
        getattr(torch, dtype))
    valid = torch.ones((b * s, 1), dtype=torch.bool, device=dev)
    valid[1] = False
    k_row = torch.randint(1, 4, (b * s,), generator=g, device=dev)
    want = "gather" if phase == "decode" else "grouped_kernel"
    tops.reset_launches()
    got, aux = hierarchical_moe_ffn(x, p, cfg, use_kernel=True, phase=phase,
                                    valid=valid, k_row=k_row)
    name = "moe_gather" if want == "gather" else "moe_gmm_ragged"
    assert tops.LAUNCHES[name] == 1
    ref, _ = hierarchical_moe_ffn(
        x, p, cfg, use_kernel=False, phase=phase, valid=valid, k_row=k_row,
        backend="gather" if want == "gather" else "grouped_plain")
    tol = (1e-4 if dtype == "float32" else 2e-2) * \
        ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    assert int(aux["dropped"]) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["decode", "mixed"])
def test_cuda_hierarchical_ffn_is_width_invariant(phase):
    """bf16 on the kernel path: a token's hierarchical output is bitwise
    the same alone and among 26 tokens (gather at decode, the ragged
    kernel on fused steps), through the outer segment products as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.core.hierarchical import hierarchical_moe_ffn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    cfg, p = _hier_case(g, dev, "bfloat16")
    x = torch.randn((26, 1, 1024), generator=g, device=dev).to(
        torch.bfloat16)
    full, _ = hierarchical_moe_ffn(x, p, cfg, use_kernel=True, phase=phase)
    for r in (0, 13, 25):
        one, _ = hierarchical_moe_ffn(x[r:r + 1], p, cfg, use_kernel=True,
                                      phase=phase)
        assert torch.equal(one[0], full[r]), r
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,bs", [(75, 16), (600, 16), (600, 8)])
def test_cuda_paged_attn_llama4_group_matches_plain(dtype, depth, bs):
    """paged_attn_decode at llama4's grouping, 8 kv heads of 128 with 5
    query heads each, on fragmented tables with two rows sharing a lane
    and an all-trash padding row, in views of one and of several 256-key
    chunks, against its plain version; and each row bitwise the same
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    rows, kh, grp, hd = 6, 8, 5, 128
    kp, vp, table = _pools(g, dev, dt, rows, depth, bs, (kh, hd))
    table[1] = table[0]                          # two rows share a lane
    table[5] = 0                                 # an all-trash padding row
    pos = torch.tensor([depth, depth - 5, depth // 2, 255, 256, 0],
                       dtype=torch.int32, device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev).to(dt)
    tops.reset_launches()
    got = tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                 scale=hd ** -0.5)
    ref = paged_attn_decode_plain(q, kp, vp, table, pos, 0, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_attn_decode"] == 1
    assert torch.isfinite(got).all()
    _close_rows(got, ref, dt)
    for i in range(rows):
        one = tops.paged_attn_decode(q[i:i + 1], kp, vp, table=table[i:i + 1],
                                     pos=pos[i:i + 1], scale=hd ** -0.5)
        assert torch.equal(one, got[i:i + 1]), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase,t,want", [
    ("prefill", 128, "gather"), ("prefill", 256, "grouped_kernel"),
    ("decode", 4, "gather"), ("mixed", 129, "grouped_kernel")])
def test_cuda_llama4_moe_ffn_matches_plain(dtype, phase, t, want):
    """llama4's pretrained MoE FFN (128 experts top-1 and a shared expert)
    at a medium width on the kernel path against its plain path, on both
    sides of the gather / grouped break-even (t <= E / k = 128 tokens runs
    moe_gather, more moe_gmm_ragged), with a masked row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from types import SimpleNamespace

    from repro_torch.config import MoEConfig
    from repro_torch.core.experts import microbatch_backend
    from repro_torch.models.moe import moe_ffn
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    e, d, m = 128, 512, 256
    cfg = SimpleNamespace(name="llama4-medium", activation="swiglu",
                          cmoe=None,
                          moe=MoEConfig(num_experts=e, top_k=1, d_expert=m,
                                        num_shared=1, d_shared=m))
    assert microbatch_backend(cfg, t, phase, use_kernel=True) == want

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev) *
                shape[-2] ** -0.5).to(dt)

    p = {"router": w(d, e), "wg": w(e, d, m), "wu": w(e, d, m),
         "wd": w(e, m, d),
         "balance_bias": torch.randn(e, generator=g, device=dev) * 0.05,
         "shared_wg": w(d, m), "shared_wu": w(d, m), "shared_wd": w(m, d)}
    x = torch.randn((1, t, d), generator=g, device=dev).to(dt)
    valid = torch.ones((t, 1), dtype=torch.bool, device=dev)
    valid[1] = False
    tops.reset_launches()
    got, aux = moe_ffn(x, p, cfg, use_kernel=True, phase=phase, valid=valid)
    name = "moe_gather" if want == "gather" else "moe_gmm_ragged"
    assert tops.LAUNCHES[name] == 1
    ref, _ = moe_ffn(x, p, cfg, use_kernel=False, phase=phase, valid=valid,
                     backend="gather" if want == "gather" else
                     "grouped_plain")
    _close(got, ref, dt)
    assert int(aux["dropped"]) == 0
    torch.cuda.synchronize()


# phi3-medium-14b (d 5120, f 17920), gemma3-4b (GEGLU, d 2560, f 10240)
# and internvl2-26b (d 6144, f 16384); their S3A3E8 routed experts (5 of m
# f / 8) at a 4 x 32 prefill (top-3) and a 4-lane decode step
DENSE_ARCH_FFNS = [(5120, 17920, "swiglu"), (2560, 10240, "geglu"),
                   (6144, 16384, "swiglu")]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 128])
@pytest.mark.parametrize("d,f,act", DENSE_ARCH_FFNS)
def test_cuda_dense_archs_swiglu_ffn_matches_plain(t, d, f, act):
    """swiglu_ffn's bfloat16 route at the dense FFN widths of phi3, gemma3
    (GEGLU) and internvl2, at a decode step and a 4 x 32 prefill."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.swiglu import ROUTE_LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    x, wg, wu, wd = _bf16_case(g, dev, (t, d), (d, f), (d, f), (f, d))
    tops.reset_launches()
    got = tops.swiglu_ffn(x, wg, wu, wd, activation=act)
    ref = swiglu_ffn_plain(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES == {"tensor_core": 1}
    assert got.shape == (t, d) and got.dtype == torch.bfloat16
    _close(got, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,act", DENSE_ARCH_FFNS)
def test_cuda_dense_archs_routed_experts_match_plain(d, f, act):
    """The converted archs' routed experts (S3A3E8: 5 of m f / 8, top-3):
    moe_gmm_ragged at a 4 x 32 prefill and moe_gather at a 4-lane decode
    step with sentinel rows, each on the tensor cores against its plain
    version; rows with no assignment exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.moe_gather import \
        ROUTE_LAUNCHES as GATHER_ROUTES
    from repro_torch.kernels.moe_gmm import RAGGED_ROUTE_LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    e, k, m = 5, 3, f // 8
    x, idx, bank = _routed_case(g, dev, 128, k, e, d, m)
    tops.reset_launches()
    _, got, xp, owner, live = _ragged_rows(x, idx, bank, act)
    ref = moe_gmm_ragged_plain(xp, owner, *bank, act, 64)
    torch.cuda.synchronize()
    assert RAGGED_ROUTE_LAUNCHES == {"tensor_core": 1}
    _close(got, ref, torch.bfloat16)
    assert not got[~live].any()
    flat = idx[:4].reshape(-1).to(torch.int32)
    flat[2::5] = e                                # sentinels
    got = tops.moe_gather(x[:4], flat, *bank, top_k=k, activation=act)
    ref = moe_gather_plain(x[:4], flat, *bank, top_k=k, activation=act)
    torch.cuda.synchronize()
    assert GATHER_ROUTES == {"tensor_core": 1}
    _close(got, ref, torch.bfloat16)
    assert not got[flat == e].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,grp,hd,depth,window", [
    (1, 48, 128, 80, 0),        # granite's engine step: MQA, 48 heads
    (1, 48, 128, 1100, 0),      # granite past several 256-key chunks
    (4, 2, 256, 80, 1024),      # gemma3's local layer at the engine's depth
    (4, 2, 256, 1500, 1024),    # gemma3's window past the leading chunks
    (4, 2, 256, 1500, 0),       # gemma3's global layer
    (10, 4, 128, 300, 0),       # phi3
    (8, 6, 128, 300, 0)])       # internvl2
def test_cuda_paged_attn_dense_archs_match_plain(dtype, kh, grp, hd, depth,
                                                 window):
    """paged_attn_decode at the groupings of this slice's archs (granite's
    48 query heads on one kv head of 128, gemma3's hd 256 with and without
    its 1024-token window, phi3's 4 and internvl2's 6 query heads a kv
    head), on fragmented tables with two rows sharing a lane, against its
    plain version; and each row bitwise the same alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attn_decode_plain
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(33)
    rows = 4
    kp, vp, table = _pools(g, dev, dt, rows, depth, 16, (kh, hd))
    table[1] = table[0]                          # two rows share a lane
    pos = torch.tensor([depth, depth - 5, depth // 2, 3], dtype=torch.int32,
                       device=dev)
    q = torch.randn((rows, 1, kh * grp, hd), generator=g, device=dev).to(dt)
    sc = hd ** -0.5
    tops.reset_launches()
    got = tops.paged_attn_decode(q, kp, vp, table=table, pos=pos,
                                 window=window, scale=sc)
    ref = paged_attn_decode_plain(q, kp, vp, table, pos, window, scale=sc)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_attn_decode"] == 1
    assert got.shape == q.shape and got.dtype == dt
    _close_rows(got, ref, dt)
    for i in range(rows):
        one = tops.paged_attn_decode(q[i:i + 1], kp, vp, table=table[i:i + 1],
                                     pos=pos[i:i + 1], window=window,
                                     scale=sc)
        assert torch.equal(one, got[i:i + 1]), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_non_glu_gather_rows_are_the_grouped_rows(dtype):
    """granite's converted experts (GELU {wi, wd}, S3A3E8: 5 of 3072 on d
    6144, top-3) run the plain products on the card (the kernels are
    GLU-only): the gather backend gives each token the bits grouped_plain
    gives it, alone or among 36 tokens (a fused engine step), so the
    overlapped engine serves the sequential one's streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from types import SimpleNamespace

    from repro_torch.core.experts import routed_experts
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(34)
    t, k, e, d, m = 36, 3, 5, 6144, 3072
    x = torch.randn((t, d), generator=g, device=dev).to(dt)
    bank = {"wi": (torch.randn((e, d, m), generator=g, device=dev) *
                   d ** -0.5).to(dt),
            "wd": (torch.randn((e, m, d), generator=g, device=dev) *
                   m ** -0.5).to(dt)}
    idx = torch.rand((t, e), generator=g, device=dev).topk(k, dim=1).indices
    idx[3, 1] = e                                  # a sentinel assignment
    gates = torch.rand((t, k), generator=g, device=dev)
    gates[3, 1] = 0.0
    cfg = SimpleNamespace(activation="gelu", cmoe=None, moe=None)

    def run(rows, backend):
        return routed_experts(x[rows], bank, gates[rows], idx[rows], cfg,
                              backend=backend)[0]

    every = slice(0, t)
    got = run(every, "gather")
    assert torch.equal(got, run(every, "grouped_plain"))
    for i in (0, 3, t - 1):
        assert torch.equal(run(slice(i, i + 1), "gather"), got[i:i + 1])
        assert torch.equal(run(slice(i, i + 4), "grouped_plain"),
                           got[i:i + 4][:min(4, t - i)])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [64, 40], ids=["full", "short"])
def test_cuda_whisper_smoke_matches_cpu(frames):
    """whisper's smoke model (the enc-dec family: no kernel on its path)
    in float32 on the card against the port on the CPU, one set of weights:
    a prefill of 2 x 24 tokens over `frames` frame embeddings, then 3
    greedy decode steps against the {"self", "cross"} cache; logits within
    1e-4 of max|logit| and the same tokens at every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.config import override
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map
    cfg = override(get_smoke_config("whisper-small"), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=g),
             "frames": torch.randn((2, frames, cfg.d_model), generator=g)}
    pg = tree_map(lambda a: a.cuda(), params)
    lc, cc = cpu.prefill(params, batch, max_len=27)
    lg, cg = gpu.prefill(pg, {k: v.cuda() for k, v in batch.items()},
                         max_len=27)
    assert tuple(cg["cross"][0].shape) == (2, 2, frames, 4, 16)
    for i in range(4):
        tol = 1e-4 * lc.abs().max().item()
        assert (lg.cpu() - lc).abs().max().item() <= tol
        tc, tg = lc.argmax(-1), lg.argmax(-1)
        assert tg.cpu().tolist() == tc.tolist()
        if i == 3:
            break
        lc, cc = cpu.decode_step(params, tc[:, None], cc, 24 + i)
        lg, cg = gpu.decode_step(pg, tg[:, None], cg, 24 + i)
    torch.cuda.synchronize()


@pytest.fixture
def no_tf32():
    """TF32 products off for one test, restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b"])
def test_cuda_loss_and_grads_match_cpu(arch, no_tf32):
    """Model.loss and every gradient leaf of a smoke model in float32 (TF32
    off) on the card against the port on the CPU, one set of weights:
    the loss within 1e-5 relative, each leaf within 1e-4 of its max|g|
    (leaves with no gradient, a balance bias, are None on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.config import override
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves, tree_map
    cfg = override(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, use_kernel=False, device="cpu")
    gpu = build_model(cfg, use_kernel=False, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    (lc, _), gc = value_and_grad(lambda p: cpu.loss(p, {"tokens": tokens}),
                                 params, fill=False)
    (lg, _), gg = value_and_grad(
        lambda p: gpu.loss(p, {"tokens": tokens.cuda()}),
        tree_map(lambda a: a.cuda(), params), fill=False)
    assert abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item())
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.cpu() - a).abs().max() <= 1e-4 * a.abs().max()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_loss_refuses_kernels_and_resumes_bitwise(tmp_path):
    """On the card a model builds with its kernels on, and Model.loss
    refuses it under autograd; a kernel-free model's 4 train steps equal
    2, a checkpoint round trip and 2 more, bit for bit, in deterministic
    mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import override
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves
    from repro_torch.optim import adamw_init
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (4, 4, 65), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    kernel = build_model(cfg, device="cuda")
    assert kernel.use_kernel
    p = kernel.init(torch.Generator("cuda").manual_seed(0))
    with pytest.raises(RuntimeError, match="use_kernel"):
        kernel.loss(p, {"tokens": tokens[0]})
    m = build_model(cfg, use_kernel=False, device="cuda")
    step = make_train_step(m, lr=1e-3, warmup=1, total=4)
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def run(params, opt, steps):
            for i in steps:
                params, opt, _ = step(params, opt, {"tokens": tokens[i]})
            return params, opt

        want = run(p, adamw_init(p), range(4))
        half = run(p, adamw_init(p), range(2))
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(2, {"params": half[0], "opt": half[1]}, block=True)
        state, _ = mgr.restore({"params": p, "opt": adamw_init(p)})
        got = run(state["params"], state["opt"], range(2, 4))
    finally:
        torch.use_deterministic_algorithms(old)
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
