"""The port's paged attention against the JAX reference, on the CPU.

``paged_attn_decode_plain`` (what the port's wrapper runs for a CPU tensor
and what the CUDA kernel is held against on the card) against
``repro.kernels.ops.paged_attn_decode`` in interpret mode, on fragmented
tables, block sizes 4 and 8, grp 1 and 4, windows that mask whole leading
blocks, and a poisoned trash block. Then the per-slot and paged attention
paths and cache writes of ``repro_torch.models.attention`` against their
JAX twins. Inputs are drawn by numpy from a seed; tolerance 2e-5 in
float32 (the same arithmetic summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro_torch.kernels import ops as tops
from repro_torch.kernels.paged_attention import paged_attn_decode_plain
from repro_torch.models import attention as tatt

TOL = dict(atol=2e-5, rtol=2e-5)


def _case(rng, *, b, kh, grp, hd, bs, nblk, poison=1e4):
    """Pools with a poisoned trash block 0, fragmented tables whose dead
    tail entries point at trash, and staggered positions (a fresh lane at
    0, a full lane)."""
    nblocks = 1 + b * nblk
    kp = rng.standard_normal((nblocks, bs, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((nblocks, bs, kh, hd)).astype(np.float32)
    kp[0], vp[0] = poison, -poison
    pos = np.array([0, bs - 1, 2 * bs + 3, nblk * bs - 1][:b] +
                   [nblk * bs - 3] * max(0, b - 4), np.int32)
    perm = rng.permutation(np.arange(1, nblocks))
    table = np.zeros((b, nblk), np.int32)
    taken = 0
    for i in range(b):
        live = int(pos[i]) // bs + 1
        table[i, :live] = perm[taken:taken + live]
        taken += live
    q = rng.standard_normal((b, 1, kh * grp, hd)).astype(np.float32)
    return q, kp, vp, table, pos


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("grp", [1, 4])
@pytest.mark.parametrize("window", [0, 13])
def test_paged_attn_plain_matches_jax(bs, grp, window):
    """window 13 with lanes 2 and 3 deep in their tables masks whole
    leading blocks; the last row, at pos -1, masks every key (the view's
    mean)."""
    rng = np.random.default_rng(bs * 10 + grp + window)
    q, kp, vp, table, pos = _case(rng, b=6, kh=2, grp=grp, hd=16, bs=bs,
                                  nblk=6)
    pos[5] = -1
    scale = 16 ** -0.5
    want = jops.paged_attn_decode(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), table=jnp.asarray(table),
                                  pos=jnp.asarray(pos), window=window,
                                  scale=scale)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    got = paged_attn_decode_plain(*t, window, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tops.reset_launches()
    routed = tops.paged_attn_decode(*t[:3], table=t[3], pos=t[4],
                                    window=window, scale=scale)
    assert torch.equal(routed, got)
    assert tops.LAUNCHES["paged_attn_decode"] == 0


@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("p", [-1, -7])
def test_paged_attn_plain_at_negative_pos_is_the_view_mean(window, p):
    """A row whose mask keeps no key (pos < 0) is the uniform average of
    its view's V rows (nblk x bs keys, trash entries included), in the
    JAX kernel and the plain version alike: the function the CUDA kernel is
    held to on the card."""
    rng = np.random.default_rng(40 + window - p)
    q, kp, vp, table, pos = _case(rng, b=4, kh=2, grp=2, hd=16, bs=4, nblk=6)
    pos[:] = p
    scale = 16 ** -0.5
    want = np.asarray(jops.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        table=jnp.asarray(table), pos=jnp.asarray(pos), window=window,
        scale=scale))
    got = paged_attn_decode_plain(*(torch.from_numpy(a) for a in
                                    (q, kp, vp, table, pos)), window,
                                  scale=scale).numpy()
    view = vp[table].reshape(4, 24, 2, 16)           # (b, t, kh, hd)
    mean = np.repeat(view.mean(axis=1), 2, axis=1)[:, None]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, mean, atol=1e-5 * np.abs(mean).max(),
                               rtol=0)


@pytest.mark.parametrize("window", [0, 5])
def test_rows_attention_matches_paged_ragged_jax(window):
    """A multi-token chunk through the kernel route (one kernel row per
    query) against the reference's materializing paged ragged attention,
    and the same lanes held as a contiguous cache (a pool of one block per
    lane) giving the same rows."""
    rng = np.random.default_rng(7 + window)
    b, s, kh, grp, hd, bs, nblk = 3, 4, 2, 2, 8, 4, 5
    q, kp, vp, table, _ = _case(rng, b=b, kh=kh, grp=grp, hd=hd, bs=bs,
                                nblk=nblk, poison=0.0)
    table = np.stack([rng.permutation(np.arange(1, 1 + b * nblk))[:nblk]
                      for _ in range(b)]).astype(np.int32)
    q = rng.standard_normal((b, s, kh * grp, hd)).astype(np.float32)
    start = np.array([0, 5, 13], np.int32)
    want = jatt.paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        table=jnp.asarray(table), pos=jnp.asarray(start), window=window)
    tq, tk, tv, tt, ts = (torch.from_numpy(a)
                          for a in (q, kp, vp, table, start))
    got = tatt.rows_attention(tq, tk, tv, table=tt, pos=ts, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kc = tatt.paged_view(tk, tt).contiguous()
    vc = tatt.paged_view(tv, tt).contiguous()
    lanes = tatt.rows_attention(tq, kc, vc, table=tatt._lane_table(b, "cpu"),
                                pos=ts, window=window)
    np.testing.assert_allclose(lanes.numpy(), got.numpy(), **TOL)


def test_paged_and_slot_cache_writes_match_jax():
    """In-place writes against the reference's functional ones: a chunk
    tail spilling past the table goes to the trash block (paged), and
    writes past the lane length are dropped (contiguous)."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((7, 4, 2, 3)).astype(np.float32)
    vals = rng.standard_normal((2, 5, 2, 3)).astype(np.float32)
    table = np.array([[3, 1], [6, 0]], np.int32)
    pos = np.array([5, 2], np.int32)
    want = jatt.paged_cache_update(jnp.asarray(pool), jnp.asarray(vals),
                                   jnp.asarray(pos), jnp.asarray(table))
    got = tatt.paged_cache_update(torch.from_numpy(pool.copy()),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(table))
    # the trash block takes several colliding spills: compare the rest
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    cache = rng.standard_normal((2, 9, 2, 3)).astype(np.float32)
    pos = np.array([6, 1], np.int32)
    want = jatt.slot_cache_update(jnp.asarray(cache), jnp.asarray(vals),
                                  jnp.asarray(pos))
    got = tatt.slot_cache_update(torch.from_numpy(cache.copy()),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
