"""Mamba2 (SSM) and the zamba2 hybrid in the port against the JAX
reference, on the CPU, in float32.

``ssd_scan_plain`` (what the port's wrapper runs for a CPU tensor and what
the CUDA kernel is held against on the card) against the JAX Pallas
kernel's wrapper in interpret mode (no state) and against the JAX
``ssd_chunked`` with a nonzero state, at ragged lengths and at chunks
other than JAX's: tolerance 1e-5 relative to max|ref| (the same
arithmetic, summed in another order or chunked elsewhere). Then the conv,
the recurrent step and the whole block with params carried by the bridge
(atol/rtol 2e-5), the bridge round trip of every leaf of both archs (bf16
bit for bit), the smoke slices of both archs (forward logits within 1e-4,
prefill + 8 greedy decode tokens identical), the port's own prefill +
decode against its forward (3e-4, as the JAX package's test), and the
static CLI with its refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
TOL = dict(atol=2e-5, rtol=2e-5)


def _close(got, exp, rel=1e-5):
    """|got - exp| <= rel * max|exp| (elementwise), float32."""
    exp = np.asarray(exp)
    scale = float(np.abs(exp).max())
    err = float(np.abs(np.asarray(got) - exp).max())
    assert err <= rel * scale, (err, scale)


def _scan_inputs(rng, b, s, nh, hp, n, state=False):
    """dt post-softplus in (0.05, 1], a_log around 0 (A near -1): decays
    that span several e-folds over a chunk, as a trained model's do."""
    xh = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (b, s, nh)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(nh)).astype(np.float32)
    d_skip = rng.standard_normal(nh).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hp, n)).astype(np.float32) \
        if state else None
    return xh, dt, bm, cm, a_log, d_skip, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("s,chunk_j,chunk_t", [
    (32, 16, 16), (37, 16, 16), (37, 16, 8), (20, 32, 64)])
def test_ssd_scan_plain_matches_jax_kernel(s, chunk_j, chunk_t):
    """No state: the JAX wrapper runs the Pallas kernel (interpret mode),
    padding S to its chunk; the port's plain version at its own chunk."""
    args = _scan_inputs(np.random.default_rng(s + chunk_t), 2, s, 3, 8, 16)
    yj, hj = jops.ssd_scan(*map(_j, args[:6]), chunk=chunk_j)
    yt, ht = ssd_scan_plain(*map(_t, args[:6]), chunk_t)
    assert yt.dtype == ht.dtype == torch.float32
    _close(yt.numpy(), yj)
    _close(ht.numpy(), hj)


@pytest.mark.parametrize("s,chunk_t", [(24, 8), (29, 16), (29, 64)])
def test_ssd_scan_plain_matches_jax_chunked_from_a_state(s, chunk_t):
    """A nonzero h0 (the path the JAX wrapper hands to ssd_chunked, and
    the one the port's prefill takes into the kernel)."""
    args = _scan_inputs(np.random.default_rng(s), 2, s, 3, 8, 16,
                        state=True)
    yj, hj = jssm.ssd_chunked(*map(_j, args[:6]), 16, h0=_j(args[6]))
    yt, ht = ssd_scan_plain(*map(_t, args[:6]), chunk_t, h0=_t(args[6]))
    _close(yt.numpy(), yj)
    _close(ht.numpy(), hj)


@pytest.mark.parametrize("s,chunk_j,chunk_t", [(37, 16, 8), (70, 32, 16)])
def test_ssd_scan_passes_match_jax_kernel(s, chunk_j, chunk_t):
    """The CUDA kernels' three passes, composed in their plain mirrors
    (chunk states, state passing, chunk outputs), from no state over
    several chunks ending ragged, against the JAX Pallas kernel in
    interpret mode."""
    args = _scan_inputs(np.random.default_rng(s + 1), 2, s, 3, 8, 16)
    yj, hj = jops.ssd_scan(*map(_j, args[:6]), chunk=chunk_j)
    yt, ht = tscan.ssd_scan_passes_plain(*map(_t, args[:6]), chunk_t)
    _close(yt.numpy(), yj)
    _close(ht.numpy(), hj)


@pytest.mark.parametrize("s,chunk_t", [(29, 8), (45, 16), (16, 16)])
def test_ssd_scan_passes_match_jax_chunked_from_a_state(s, chunk_t):
    """The passes from a nonzero h0 against JAX's ssd_chunked, over
    several chunks ending ragged and over exactly one."""
    args = _scan_inputs(np.random.default_rng(s + 2), 2, s, 3, 8, 16,
                        state=True)
    yj, hj = jssm.ssd_chunked(*map(_j, args[:6]), 16, h0=_j(args[6]))
    yt, ht = tscan.ssd_scan_passes_plain(*map(_t, args[:6]), chunk_t,
                                         h0=_t(args[6]))
    _close(yt.numpy(), yj)
    _close(ht.numpy(), hj)


def test_ssd_state_pass_plain_chains_chunk_states():
    """Pass 2 alone: each start state is the last one decayed by its
    chunk's exp(l_end) plus that chunk's own state."""
    rng = np.random.default_rng(8)
    states = torch.from_numpy(rng.standard_normal((2, 3, 2, 4, 5))
                              .astype(np.float32))
    lend = torch.from_numpy(-rng.uniform(0, 3, (2, 3, 2)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 2, 4, 5))
                          .astype(np.float32))
    starts = tscan.ssd_state_pass_plain(states, lend, h0)
    h = h0
    for i in range(3):
        h = h * torch.exp(lend[:, i])[..., None, None] + states[:, i]
        torch.testing.assert_close(starts[:, i], h, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_kernel_plan_fits_the_archs(arch):
    """The CUDA kernels' plan at both archs' full widths: a prefill of 32
    tokens is one chunk of 32 (one launch), a long forward chunks of 64,
    each within a block's shared memory; heads a block divide nh and leave
    at least three blocks an SM of an H100 (132) where there are that many
    (head, chunk) pairs."""
    cfg = get_config(arch)
    n, hp = cfg.ssm.state_size, cfg.ssm.head_dim
    nh = tssm.num_ssm_heads(cfg)
    assert tscan.kernel_chunk(32, n) == tscan.SHORT_CHUNK
    assert tscan.kernel_chunk(2048, n) == tscan.KERNEL_CHUNK
    for seq in (1, 32, 2048):
        chunk = tscan.kernel_chunk(seq, n)
        assert tscan.smem_bytes(n, chunk, 4) <= tscan.MAX_SMEM_BYTES
        nc = -(-seq // chunk)
        hg = tscan.heads_per_block(4, nc, nh, hp, 132)
        assert nh % hg == 0 and hg <= tscan.MAX_HEADS_PER_BLOCK
        assert hg == 1 or 4 * nc * nh // hg >= 3 * 132
    assert tscan.heads_per_block(2, 32, 32, 64, 132) == 4
    assert tscan.smem_bytes(512, tscan.kernel_chunk(4, 512)) > \
        tscan.MAX_SMEM_BYTES


def test_ssd_step_matches_jax():
    xh, dt, bm, cm, a_log, d_skip, h0 = _scan_inputs(
        np.random.default_rng(3), 2, 1, 3, 8, 16, state=True)
    yj, hj = jssm.ssd_step(*map(_j, (xh, dt, bm, cm, a_log, d_skip, h0)))
    yt, ht = tssm.ssd_step(*map(_t, (xh, dt, bm, cm, a_log, d_skip, h0)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    yj, sj = jssm._causal_conv(_j(x), _j(w), _j(bias), _j(state))
    yt, st = tssm._causal_conv(_t(x), _t(w), _t(bias), _t(state))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _cfgs(arch, dtype="float32"):
    return (joverride(j_smoke(arch), dtype=dtype),
            override(get_smoke_config(arch), dtype=dtype))


def _params(arch, dtype="float32", seed=0):
    cfg_j, _ = _cfgs(arch, dtype)
    pj = jax.jit(jbuild(cfg_j).init)(jax.random.PRNGKey(seed))
    return pj, params_from_jax_numpy(jax.device_get(pj), "cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", ["no_cache", "zero_cache", "decode"])
def test_mamba2_block_matches_jax(mode, use_kernel):
    """The mixer of layer 0 of the mamba2 smoke model, with trained-looking
    SSM leaves (a_log, d_skip, dt_bias, conv bias drawn at random): no
    cache (S 20, over one chunk of 16), a zero cache (the prefill path)
    and one decode step from a random state. The caches come back updated
    in place, equal to JAX's new ones."""
    cfg_j, cfg_t = _cfgs("mamba2-370m")
    pj, _ = _params("mamba2-370m")
    rng = np.random.default_rng(5)
    p = {k: np.array(v[0]) for k, v in
         jax.device_get(pj["blocks"]["mixer"]).items()}
    for k in ("a_log", "d_skip", "dt_bias", "conv_b"):
        p[k] = (0.5 * rng.standard_normal(p[k].shape)).astype(np.float32)
    seq = 1 if mode == "decode" else 20
    x = rng.standard_normal((2, seq, cfg_t.d_model)).astype(np.float32)
    cache = None
    if mode != "no_cache":
        conv_shape = (2, cfg_t.ssm.conv_width - 1,
                      tssm.d_inner(cfg_t) + 2 * cfg_t.ssm.state_size)
        nh = tssm.num_ssm_heads(cfg_t)
        ssm_shape = (2, nh, tssm.d_inner(cfg_t) // nh, cfg_t.ssm.state_size)
        draw = rng.standard_normal if mode == "decode" else np.zeros
        cache = (draw(conv_shape).astype(np.float32),
                 draw(ssm_shape).astype(np.float32))
    yj, cj = jssm.mamba2_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, cfg_j,
        cache=None if cache is None else tuple(map(jnp.asarray, cache)),
        use_kernel=use_kernel)
    ct = None if cache is None else tuple(torch.from_numpy(c.copy())
                                          for c in cache)
    yt, ct_out = tssm.mamba2_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg_t, cache=ct, use_kernel=use_kernel)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    if cache is None:
        assert ct_out is None
        return
    assert ct_out[0] is ct[0] and ct_out[1] is ct[1]
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), **TOL)
    np.testing.assert_allclose(ct[1].numpy(), np.asarray(cj[1]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_every_ssm_leaf(arch):
    """Every leaf of the mamba tree (and zamba2's shared attention + FFN
    block) crosses the bridge with its key path, shape, dtype and bits:
    bfloat16 weights bit for bit, the float32 a_log / d_skip / dt_bias of
    a bf16 model as float32; the port's own init draws the same tree."""
    pj, pt = _params(arch, "bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(pj)
    names = {"/".join(k.key for k in path) for path, _ in leaves}
    want = {f"blocks/mixer/{k}" for k in (
        "in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
        "out_norm", "out_proj")} | {"blocks/norm1", "embed", "final_norm"}
    if arch == "zamba2-1.2b":
        want |= {"lm_head", "shared_attn/norm1", "shared_attn/attn/wq",
                 "shared_attn/attn/wk", "shared_attn/attn/wv",
                 "shared_attn/attn/wo", "shared_attn/norm2",
                 "shared_attn/ffn/wg", "shared_attn/ffn/wu",
                 "shared_attn/ffn/wd"}
    assert names == want
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
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), leaf)
    f32 = {"/".join(k.key for k in path) for path, leaf in leaves
           if np.asarray(leaf).dtype == np.float32}
    assert f32 == {"blocks/mixer/a_log", "blocks/mixer/d_skip",
                   "blocks/mixer/dt_bias"}
    mt = build_model(_cfgs(arch, "bfloat16")[1], device="cpu")
    mine = mt.init(torch.Generator().manual_seed(0))
    flat = {"/".join(k.key for k in path): (np.asarray(leaf).shape,
                                            str(np.asarray(leaf).dtype))
            for path, leaf in leaves}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", (tuple(v.shape),
                                       str(v.dtype).replace("torch.", ""))

    assert dict(walk(mine)) == flat


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_smoke_slice_matches_jax(arch, use_kernel):
    """The whole smoke slice from one set of JAX params, kernels off and
    on (JAX's Pallas scan in interpret mode for the forward): forward
    logits (2 x 24 tokens, over one chunk of 16) within 1e-4; prefill (2 x
    12) logits within 1e-4 and 8 greedy decode tokens identical, with the
    top-2 logit gaps far above the tolerance (no near-tie)."""
    cfg_j, cfg_t = _cfgs(arch)
    mj = jbuild(cfg_j, use_kernel=use_kernel)
    pj, pt = _params(arch)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    # a prompt whose greedy steps have no near-tie in either arch (seed 0
    # has a 1e-4 gap at one mamba2 step, where the comparison says little)
    tok = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, 24))
    fj = jax.jit(lambda p, t: mj.forward(p, {"tokens": t}))(
        pj, jnp.asarray(tok))
    ft = mt.forward(pt, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-4,
                               rtol=1e-4)
    max_len = 12 + 8
    lj, cj = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t},
                                              max_len=max_len))(
        pj, jnp.asarray(tok[:, :12]))
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok[:, :12])},
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


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, use_kernel):
    """Within the port: prefill(16) + decode == teacher-forced forward at
    each position (3e-4, as the JAX package's test); the hybrid's shared
    block fills its own KV slice per application."""
    cfg = override(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 19)))
    full = model.forward(params, {"tokens": tok})
    lg, cache = model.prefill(params, {"tokens": tok[:, :16]}, max_len=19)
    np.testing.assert_allclose(lg.numpy(), full[:, 15].numpy(), atol=3e-4,
                               rtol=3e-4)
    for i in range(16, 19):
        lg, cache = model.decode_step(params, tok[:, i:i + 1], cache, i)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   atol=3e-4, rtol=3e-4)
    if arch == "zamba2-1.2b":
        _, k, v = cache
        assert k.shape[0] == 2 and bool((k[:, :, :19] != 0).all())
        assert bool((v[:, :, 19:] == 0).all())
    with pytest.raises(NotImplementedError, match="slot-addressable"):
        model.init_paged_cache(4, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_static_serves_on_cpu(arch):
    res = tserve.run(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "4",
                      "--use-kernel"])
    toks = np.asarray(res["tokens"])
    assert toks.shape == (2, 4) and toks.min() >= 0 and toks.max() < 256
    assert res["backends"] == {"prefill": None, "decode": None}
    assert torch.isfinite(res["prefill_logits"]).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flag,exc,err", [
    (["--cmoe", "S3A3E8"], ValueError, "does not apply"),
    (["--continuous"], NotImplementedError, "not slot-addressable"),
    (["--continuous", "--paged"], NotImplementedError,
     "not slot-addressable")])
def test_cli_refuses_conversion_and_engine(arch, flag, exc, err):
    """The reference's refusals: conversion does not apply to the SSM and
    hybrid families; the engine needs a positional KV cache (before the
    smoke engine's implicit --cmoe)."""
    with pytest.raises(exc, match=err):
        tserve.run(["--arch", arch, "--smoke", "--device", "cpu"] + flag)
