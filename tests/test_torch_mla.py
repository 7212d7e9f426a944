"""deepseek-v2's multi-head latent attention (MLA) in the port against the
JAX reference, on the CPU, in float32.

``mla_paged_decode_plain`` (what the port's wrapper runs for a CPU tensor
and what the CUDA kernel is held against on the card) against the JAX
Pallas kernel in interpret mode, on fragmented tables, rows sharing blocks
and an all-trash row: tolerance 1e-5 relative to max|ref| (the same
arithmetic summed in another order). Then ``mla_attention`` on every cache
branch with the same params carried by the bridge (atol/rtol 2e-5; the
port's kernel route runs per-slot prefill chunks in the absorbed form
where the reference expands K/V, which agrees within the same tolerance),
the bridge round trip of every deepseek-v2 leaf, and the whole smoke slice
(prefill logits within 1e-4 and 8 identical greedy tokens).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import override
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.paged_attention import mla_paged_decode_plain
from repro_torch.models import attention as tatt
from repro_torch.models import build_model

ARCH = "deepseek-v2-236b"
TOL = dict(atol=2e-5, rtol=2e-5)


def _cfgs():
    return (joverride(j_smoke(ARCH), dtype="float32"),
            override(get_smoke_config(ARCH), dtype="float32"))


def _mla_case(rng, *, b, h, r, dr, bs, nblk):
    """Latent pools with a poisoned trash block 0, fragmented tables (a
    lane's dead tail entries point at trash), rows 0 and 1 sharing their
    blocks at two depths, and the last row all trash."""
    nblocks = 1 + b * nblk
    cc = rng.standard_normal((nblocks, bs, r)).astype(np.float32)
    cp = rng.standard_normal((nblocks, bs, dr)).astype(np.float32)
    cc[0], cp[0] = 1e4, -1e4
    pos = np.array([nblk * bs - 1, bs + 2, 2 * bs - 1, 3, 0][:b], np.int32)
    perm = rng.permutation(np.arange(1, nblocks))
    table = np.zeros((b, nblk), np.int32)
    taken = 0
    for i in range(b - 1):
        live = int(pos[i]) // bs + 1
        table[i, :live] = perm[taken:taken + live]
        taken += live
    table[1] = table[0]
    qa = rng.standard_normal((b, h, r)).astype(np.float32)
    qp = rng.standard_normal((b, h, dr)).astype(np.float32)
    return qa, qp, cc, cp, table, pos


def _with_negative_pos_row(rng, qa, qp, table, pos):
    """The case with a sixth row at pos -1 on row 0's lane: every key
    masked, so the softmax is the uniform average of the view."""
    qa = np.concatenate([qa, rng.standard_normal(qa[:1].shape).astype(
        np.float32)])
    qp = np.concatenate([qp, rng.standard_normal(qp[:1].shape).astype(
        np.float32)])
    return (qa, qp, np.concatenate([table, table[:1]]),
            np.concatenate([pos, np.array([-1], np.int32)]))


@pytest.mark.parametrize("bs", [4, 8])
def test_mla_paged_decode_plain_matches_jax(bs):
    rng = np.random.default_rng(bs)
    qa, qp, cc, cp, table, pos = _mla_case(rng, b=5, h=4, r=32, dr=8, bs=bs,
                                           nblk=5)
    qa, qp, table, pos = _with_negative_pos_row(rng, qa, qp, table, pos)
    scale = (16 + 8) ** -0.5
    want = np.asarray(jops.mla_paged_decode(
        *(jnp.asarray(a) for a in (qa, qp, cc, cp)),
        table=jnp.asarray(table), pos=jnp.asarray(pos), scale=scale))
    t = [torch.from_numpy(a) for a in (qa, qp, cc, cp, table, pos)]
    got = mla_paged_decode_plain(*t, scale=scale)
    # real rows, the trash row, the pos -1 row
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        ref = want[sl]
        np.testing.assert_allclose(got.numpy()[sl], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    tops.reset_launches()
    routed = tops.mla_paged_decode(*t[:4], table=t[4], pos=t[5],
                                   scale=scale)
    assert torch.equal(routed, got)
    assert tops.LAUNCHES["mla_paged_decode"] == 0


@pytest.mark.parametrize("p", [-1, -5])
def test_mla_paged_decode_plain_at_negative_pos_is_the_view_mean(p):
    """A row whose mask keeps no key (pos < 0) is the uniform average of its
    view's latent rows (nblk x bs keys), in the JAX kernel and the plain
    version alike: the function the CUDA kernel is held to on the card."""
    rng = np.random.default_rng(20 - p)
    qa, qp, cc, cp, table, pos = _mla_case(rng, b=4, h=4, r=32, dr=8, bs=4,
                                           nblk=5)
    pos[:] = p
    scale = (16 + 8) ** -0.5
    want = np.asarray(jops.mla_paged_decode(
        *(jnp.asarray(a) for a in (qa, qp, cc, cp)),
        table=jnp.asarray(table), pos=jnp.asarray(pos), scale=scale))
    got = mla_paged_decode_plain(*(torch.from_numpy(a) for a in
                                   (qa, qp, cc, cp, table, pos)),
                                 scale=scale).numpy()
    mean = np.repeat(cc[table].reshape(4, 20, 32).mean(axis=1)[:, None], 4,
                     axis=1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, mean, rtol=0,
                               atol=1e-5 * np.abs(mean).max())


LOG2E = 1.4426950408889634


def _mla_split_plain(qa, qp, cc_pool, cp_pool, table, pos, *, scale,
                     chunk):
    """The tensor-core route's split form (csrc/mla_tc.cuh) in plain torch:
    each row's counted keys (those <= pos; every view key at -1e30 where
    pos < 0) cut into chunks of `chunk` logical positions, a chunk's (m, l,
    acc) in log2 units with p rounded to the pool's dtype for the value
    product, then the live chunks merged in chunk order, out = acc /
    max(l, 1e-30); where the view fits one chunk, no merge runs and a row
    is its one chunk's acc / max(l, 1e-30), as the kernel writes it."""
    b, nblk = table.shape
    bs, r = cc_pool.shape[1], cc_pool.shape[2]
    view = nblk * bs
    tl = table.long()
    cc = cc_pool[tl].reshape(b, view, r)
    cp = cp_pool[tl].reshape(b, view, -1)
    s2 = (torch.einsum("bhr,btr->bht", qa.float(), cc.float()) +
          torch.einsum("bhp,btp->bht", qp.float(), cp.float())) * \
        (scale * LOG2E)
    rows = []
    for i in range(b):
        p = int(pos[i])
        last = view - 1 if p < 0 else min(p, view - 1)
        parts = []
        for lo in range(0, last + 1, chunk):
            hi = min(lo + chunk - 1, last)
            sc = s2[i, :, lo:hi + 1]
            if p < 0:
                sc = torch.full_like(sc, -1e30)
            m = sc.max(-1).values
            pr = torch.exp2(sc - m[:, None])
            acc = pr.to(cc.dtype).float() @ cc[i, lo:hi + 1].float()
            parts.append((m, pr.sum(-1), acc))
        if view <= chunk:
            _, l, acc = parts[0]
            rows.append(acc / l.clamp_min(1e-30)[:, None])
            continue
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        l = torch.zeros_like(mx)
        acc = torch.zeros_like(parts[0][2])
        for m, lc, ac in parts:
            wt = torch.exp2(m - mx)
            l = l + lc * wt
            acc = acc + ac * wt[:, None]
        rows.append(acc / l.clamp_min(1e-30)[:, None])
    return torch.stack(rows).to(qa.dtype)


@pytest.mark.parametrize("bs,chunk", [(4, 8), (8, 16), (4, 12)])
def test_mla_split_form_matches_jax(bs, chunk):
    """The split form over views of several chunks against the JAX kernel
    in interpret mode, in float32: rows at and beside the chunk edges, a
    row whose counted keys fit the first chunk of a multi-chunk view (its
    merge weighs one chunk), a row past the view's end, and rows at pos
    -1 over the whole view."""
    rng = np.random.default_rng(40 + bs + chunk)
    b, h, r, dr, nblk = 9, 4, 32, 8, 10
    nblocks = 1 + b * nblk
    cc = rng.standard_normal((nblocks, bs, r)).astype(np.float32)
    cp = rng.standard_normal((nblocks, bs, dr)).astype(np.float32)
    cc[0], cp[0] = 1e4, -1e4
    table = (rng.permutation(np.arange(1, nblocks))[:b * nblk]
             .reshape(b, nblk).astype(np.int32))
    view = nblk * bs
    pos = np.array([chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
                    3, view - 1, view + 5, -1], np.int32)
    assert view > 2 * chunk
    qa = rng.standard_normal((b, h, r)).astype(np.float32)
    qp = rng.standard_normal((b, h, dr)).astype(np.float32)
    scale = (16 + dr) ** -0.5
    want = np.asarray(jops.mla_paged_decode(
        *(jnp.asarray(a) for a in (qa, qp, cc, cp)),
        table=jnp.asarray(table), pos=jnp.asarray(pos), scale=scale))
    t = [torch.from_numpy(a) for a in (qa, qp, cc, cp, table, pos)]
    got = _mla_split_plain(*t, scale=scale, chunk=chunk).numpy()
    for i in range(b):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=1e-5 * np.abs(want[i]).max())
    # one live chunk through the merge is bitwise the row without it
    one = _mla_split_plain(*t, scale=scale, chunk=view).numpy()
    np.testing.assert_array_equal(got[5], one[5])


def test_mla_split_form_rounds_p_like_the_plain_version():
    """In bfloat16 the split form (p rounded to the pool's dtype per chunk)
    stays within the card's tolerance of the plain version over several
    chunks, and a row with one live chunk is bitwise the same through a
    merge of a wider view."""
    g = torch.Generator().manual_seed(7)
    b, h, r, dr, bs, nblk = 4, 12, 64, 16, 8, 12
    cc = torch.randn((1 + b * nblk, bs, r), generator=g).bfloat16()
    cp = torch.randn((1 + b * nblk, bs, dr), generator=g).bfloat16()
    table = (torch.randperm(b * nblk, generator=g) + 1).reshape(
        b, nblk).to(torch.int32)
    pos = torch.tensor([95, 31, 40, -1], dtype=torch.int32)
    qa = torch.randn((b, h, r), generator=g).bfloat16()
    qp = torch.randn((b, h, dr), generator=g).bfloat16()
    got = _mla_split_plain(qa, qp, cc, cp, table, pos, scale=0.1, chunk=32)
    ref = mla_paged_decode_plain(qa, qp, cc, cp, table, pos, scale=0.1)
    for i in range(b):
        err = (got[i].float() - ref[i].float()).abs().max().item()
        assert err <= 2e-2 * ref[i].float().abs().max().item()
    narrow = _mla_split_plain(qa[1:2], qp[1:2], cc, cp, table[1:2, :4],
                              pos[1:2], scale=0.1, chunk=32)
    assert torch.equal(narrow, got[1:2])


@functools.lru_cache(maxsize=None)
def _attn_params(seed=0):
    """One smoke layer's MLA params from the JAX init, and the bridge's
    copy of them (drawn once per process)."""
    cfg_j, cfg_t = _cfgs()
    pj = jblocks.init_mla(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    pt = params_from_jax_numpy(jax.device_get(pj), "cpu")
    return cfg_j, cfg_t, pj, pt


def _pools(rng, cfg, n, bs):
    m = cfg.mla
    return (rng.standard_normal((n, bs, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((n, bs, m.qk_rope_head_dim)).astype(
                np.float32))


BRANCHES = ["cache_free", "contiguous", "per_slot", "paged", "fused_rows"]


def _branch_steps(branch, cfg):
    """The calls of one cache branch: (x, fresh cache or None to carry the
    previous call's, keyword arguments), from a seeded numpy generator."""
    rng = np.random.default_rng(BRANCHES.index(branch))
    d = cfg.d_model
    b, t = 3, 16

    def x(rows, s):
        return rng.standard_normal((rows, s, d)).astype(np.float32)

    if branch == "cache_free":
        return [(x(b, 7), None, dict(positions=np.arange(7)))]
    if branch == "contiguous":
        # prefill at a scalar position, then absorbed decode steps
        cache = tuple(np.zeros_like(c) for c in _pools(rng, cfg, b, t))
        return [(x(b, 6), cache, dict(positions=np.arange(6), cache_pos=0))
                ] + [(x(b, 1), None, dict(positions=np.array([p]),
                                          cache_pos=p)) for p in (6, 7)]
    if branch == "per_slot":
        start = np.array([0, 3, 9], np.int32)
        return [(x(b, 4), _pools(rng, cfg, b, t),
                 dict(positions=start[:, None] + np.arange(4),
                      cache_pos=start)),
                (x(b, 1), None, dict(positions=start[:, None] + 4,
                                     cache_pos=start + 4))]
    if branch == "paged":
        bs, nblk = 4, 4
        cache = _pools(rng, cfg, 1 + b * nblk, bs)
        table = (rng.permutation(b * nblk) + 1).reshape(b, nblk).astype(
            np.int32)
        start = np.array([0, 5, 10], np.int32)
        return [(x(b, 3), cache, dict(positions=start[:, None] +
                                      np.arange(3), cache_pos=start,
                                      block_table=table)),
                (x(b, 1), None, dict(positions=start[:, None] + 3,
                                     cache_pos=start + 3,
                                     block_table=table))]
    # fused rows over the contiguous cache: lane 1 takes a 3-token chunk as
    # three rows, lanes 0 and 2 one decode row each, and a padding row
    # duplicating row 0
    slots = np.array([0, 1, 1, 1, 2, 0], np.int32)
    pos = np.array([5, 2, 3, 4, 9, 5], np.int32)
    xs = x(6, 1)
    xs[5] = xs[0]
    return [(xs, _pools(rng, cfg, b, t),
             dict(positions=pos[:, None], cache_pos=pos, row_slots=slots))]


def _run_branch(fn, steps, to_t, from_t):
    """Run a branch's calls, carrying the updated cache. Returns the
    outputs and caches as numpy."""
    outs, caches, cur = [], [], None
    for x, cache, kw in steps:
        cache = cur if cache is None else tuple(to_t(np.array(c))
                                                for c in cache)
        o, cur = fn(to_t(x), kv_cache=cache,
                    **{k: to_t(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()})
        outs.append(from_t(o))
        caches.append(None if cur is None else
                      tuple(from_t(c) for c in cur))
    return outs, caches


@functools.lru_cache(maxsize=None)
def _jax_branch(branch):
    """The reference's outputs and caches for one branch (computed once
    and shared by the port's two routes)."""
    cfg_j, _, pj, _ = _attn_params()

    def call(x, kv_cache=None, **kw):
        # jitted, with the array arguments traced and the rest static
        arrays = {k: v for k, v in kw.items() if hasattr(v, "shape")}
        static = {k: v for k, v in kw.items() if k not in arrays}
        return jax.jit(lambda x, kv, a: jatt.mla_attention(
            x, pj, cfg_j, kv_cache=kv, **a, **static))(x, kv_cache, arrays)

    return _run_branch(call, _branch_steps(branch, cfg_j), jnp.asarray,
                       np.asarray)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("branch", BRANCHES)
def test_mla_attention_matches_jax(branch, use_kernel):
    """Every cache branch of mla_attention against the reference: the
    outputs and the written latent caches. With use_kernel the port routes
    every per-slot path through mla_paged_decode (its plain version here)
    in the absorbed form, where the reference expands K/V for a prefill
    chunk; both agree within the stated tolerance."""
    _, cfg_t, _, pt = _attn_params()
    want_o, want_c = _jax_branch(branch)
    got_o, got_c = _run_branch(
        lambda x, **kw: tatt.mla_attention(x, pt, cfg_t,
                                           use_kernel=use_kernel, **kw),
        _branch_steps(branch, cfg_t), torch.from_numpy,
        lambda a: a.numpy().copy())   # the port writes caches in place
    for o_t, o_j in zip(got_o, want_o):
        np.testing.assert_allclose(o_t, o_j, **TOL)
    # the paged trash block takes spilled writes in either order
    sl = slice(1, None) if branch == "paged" else slice(None)
    for c_t, c_j in zip(got_c, want_c):
        assert (c_t is None) == (c_j is None)
        for a, w in zip(c_t or (), c_j or ()):
            np.testing.assert_allclose(a[sl], w[sl], **TOL)


def test_bridge_round_trips_every_deepseek_leaf():
    """Every leaf of the mla_moe tree (attn q/kv projections and norms, the
    router, expert banks, balance bias, shared experts) crosses the bridge
    with its key path, shape and bits (bfloat16)."""
    cfg = joverride(j_smoke(ARCH), dtype="bfloat16")
    pj = jax.device_get(jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(0)))
    pt = params_from_jax_numpy(pj, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(pj)
    names = {"/".join(k.key for k in path) for path, _ in leaves}
    for want in ("blocks/attn/q_dproj", "blocks/attn/q_norm",
                 "blocks/attn/q_uproj", "blocks/attn/kv_dproj",
                 "blocks/attn/kv_norm", "blocks/attn/kv_uproj",
                 "blocks/attn/wo", "blocks/moe/router", "blocks/moe/wg",
                 "blocks/moe/wu", "blocks/moe/wd",
                 "blocks/moe/balance_bias", "blocks/moe/shared_wg",
                 "blocks/moe/shared_wu", "blocks/moe/shared_wd",
                 "embed", "lm_head", "final_norm"):
        assert want in names, want
    for path, leaf in leaves:
        node = pt
        for k in path:
            node = node[k.key]
        leaf = np.asarray(leaf)
        assert tuple(node.shape) == leaf.shape
        if leaf.dtype.name == "bfloat16":
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), leaf)
    # the port's own init draws the same tree
    mt = build_model(override(get_smoke_config(ARCH), dtype="bfloat16"),
                     device="cpu")
    mine = mt.init(torch.Generator().manual_seed(0))
    flat = {"/".join(k.key for k in path): np.asarray(leaf).shape
            for path, leaf in leaves}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(v.shape)
    assert dict(walk(mine)) == flat


@functools.lru_cache(maxsize=None)
def _model_params():
    """The smoke model's JAX params (seed 0) and the bridge's copy."""
    cfg_j, _ = _cfgs()
    pj = jax.jit(jbuild(cfg_j).init)(jax.random.PRNGKey(0))
    return pj, params_from_jax_numpy(jax.device_get(pj), "cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_deepseek_smoke_slice_matches_jax(use_kernel):
    """The whole smoke slice from one set of JAX params: Model.prefill
    logits (2 x 12 tokens) within 1e-4 and 8 greedy decode tokens
    identical; the seed's top-2 logit gaps stay far above the
    tolerance (no near-tie)."""
    cfg_j, cfg_t = _cfgs()
    mj = jbuild(cfg_j, use_kernel=use_kernel)
    pj, pt = _model_params()
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 12))
    max_len = 12 + 8
    lj, cj = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t},
                                              max_len=max_len))(
        pj, jnp.asarray(tok))
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)},
                        max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    decode_j = jax.jit(mj.decode_step)
    tj = jnp.argmax(lj, -1)[:, None]
    tt = torch.argmax(lt, -1)[:, None]
    gaps = []
    for i in range(8):
        lj, cj = decode_j(pj, tj, cj, jnp.int32(12 + i))
        lt, ct = mt.decode_step(pt, tt, ct, 12 + i)
        top2 = np.sort(np.asarray(lj), -1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        tj = jnp.argmax(lj, -1)[:, None]
        tt = torch.argmax(lt, -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert min(gaps) > 1e-3
