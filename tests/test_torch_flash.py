"""The attention pair (``flash_attention``, ``flash_decode``) in the port,
against the JAX package on the CPU.

* ``flash_attention_plain`` against the JAX ``ops.flash_attention``
  (Pallas, interpret mode, blocks of 32) at the reference test's shapes,
  causal, and ``flash_decode_plain`` against the JAX ``ops.flash_decode``
  (block 64) at the reference test's shapes, with the reference tests'
  tolerances: 2e-5 in float32, 5e-2 in bfloat16;
* the three cases where the JAX wrappers pad: a causal call with S > T and
  T not a multiple of the block, a non-causal ragged T (which the JAX
  wrapper hands to the oracle) and pos >= T. The port follows
  ``ref.flash_*_ref`` in all three; the JAX wrapper misses it in the first
  and the third, by more than the tolerance;
* the whole slice on llama2-smoke, one set of weights (JAX init, carried
  through the bridge): layer 0's q, k and v of a prefill, and layer 0's
  cache and query after a decode step, built in both packages; the JAX
  ops, the port's ops on CPU tensors (the plain versions) and the port's
  own ``chunked_attention`` / ``decode_attention`` agree within 2e-5;
* on CPU tensors the wrappers run the plain versions and count no launch;
* ``route``: bfloat16 with D a multiple of 16 up to 256 goes to the
  tensor-core kernel, everything else to the SIMT one; and the plain
  version against ``ref`` and the Pallas kernel in bfloat16 at the
  tensor-core route's widest heads (D 128 and 256), causal with S > T and
  S < T.

Inputs are drawn from seeded numpy generators."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import override
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_plain, route
from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers


def _tol(dtype, bf16=5e-2):
    t = bf16 if dtype == "bfloat16" else 2e-5
    return dict(atol=t, rtol=t)


def _inputs(seed, shapes, dtype):
    """The same numpy draws as a JAX and a torch tuple of `dtype`."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("bh,s,d", [(2, 64, 32), (3, 100, 16), (1, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(bh, s, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(bh * s + d, [(bh, s, d)] * 3, dtype)
    exp = jops.flash_attention(jq, jk, jv, causal=True, block_q=32,
                               block_k=32)
    got = flash_attention_plain(tq, tk, tv, causal=True)
    assert got.shape == (bh, s, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.parametrize("bh,t,d,pos", [(4, 100, 32, 63), (2, 512, 64, 511),
                                        (3, 70, 16, 0), (1, 33, 8, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax(bh, t, d, pos, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        bh * t + pos, [(bh, 1, d), (bh, t, d), (bh, t, d)], dtype)
    exp = jops.flash_decode(jq, jk, jv, jnp.int32(pos), block_k=64)
    got = flash_decode_plain(tq, tk, tv, pos)
    assert got.shape == (bh, 1, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.parametrize("case", ["causal S > T", "non-causal ragged T",
                                  "pos >= T"])
def test_port_follows_the_oracle_where_the_jax_wrapper_pads(case):
    """The port computes ref's function; the JAX wrapper's padded keys
    receive mass in the first and the third case (a reference fault, left
    as it is), and it hands the second to the oracle."""
    if case == "pos >= T":
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            7, [(2, 1, 32), (2, 100, 32), (2, 100, 32)], "float32")
        want = jref.flash_decode_ref(jq, jk, jv, 120)
        wrapper = jops.flash_decode(jq, jk, jv, jnp.int32(120), block_k=64)
        got = flash_decode_plain(tq, tk, tv, 120)
        got_ops = tops.flash_decode(tq, tk, tv, torch.tensor(120))
    else:
        causal = case == "causal S > T"
        s, t = (100, 50) if causal else (64, 50)
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            8, [(2, s, 32), (2, t, 32), (2, t, 32)], "float32")
        want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
        wrapper = jops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=32, block_k=32)
        got = flash_attention_plain(tq, tk, tv, causal)
        got_ops = tops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))
    np.testing.assert_allclose(_np(got_ops), _np(want), **_tol("float32"))
    gap = np.abs(_np(wrapper) - _np(want)).max()
    assert (gap > 1e-2) == (case != "non-causal ragged T"), gap


def _layer0(x, p, cfg, positions, layers, attn):
    """Layer 0's normed input through the projections and RoPE, flattened
    to (B * H, S, hd); also the unflattened (B, S, H, hd) triple."""
    xn = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = attn.gqa_project_qkv(xn, p["attn"], cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flat(x):
    """(B, S, H, hd) -> (B * H, S, hd), for either package."""
    b, s, h, d = x.shape
    if isinstance(x, torch.Tensor):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()
    return jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d)


def test_llama2_smoke_attention_pair_agrees_with_jax():
    """Prefill (2 x 24 tokens) and one decode step of llama2-smoke in both
    packages on one set of weights: layer 0's attention through the JAX
    ops, the port's ops and the port's own static attention."""
    cfg_j = joverride(j_smoke("llama2-7b"), dtype="float32")
    cfg_t = override(get_smoke_config("llama2-7b"), dtype="float32")
    mj = jbuild(cfg_j, use_kernel=False)
    pj = mj.init(jax.random.PRNGKey(0))
    mt = build_model(cfg_t, use_kernel=False, device="cpu")
    pt = params_from_jax_numpy(jax.device_get(pj), "cpu")
    b, s, max_len = 2, 24, 29
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_j.vocab_size, (b, s))
    pj0 = jax.tree_util.tree_map(lambda a: a[0], pj["blocks"])
    pt0 = {"norm1": pt["blocks"]["norm1"][0],
           "attn": {n: w[0] for n, w in pt["blocks"]["attn"].items()}}
    tol = _tol("float32")

    # prefill: layer 0's q, k, v from the prompt
    jqkv = _layer0(jlayers.embed(jnp.asarray(prompts), pj["embed"]), pj0,
                   cfg_j, jnp.arange(s), jlayers, jattn)
    tqkv = _layer0(tlayers.embed(torch.from_numpy(prompts), pt["embed"]),
                   pt0, cfg_t, torch.arange(s), tlayers, tattn)
    for a, c in zip(jqkv, tqkv):
        np.testing.assert_allclose(_np(c), _np(a), **tol)
    exp = jops.flash_attention(*(_flat(a) for a in jqkv), causal=True,
                               block_q=8, block_k=8)
    got = tops.flash_attention(*(_flat(a) for a in tqkv), causal=True)
    own = _flat(tattn.chunked_attention(*tqkv, causal=True))
    np.testing.assert_allclose(_np(got), _np(exp), **tol)
    np.testing.assert_allclose(_np(own), _np(got), **tol)

    # decode: one step at position s, then layer 0's cache and query
    _, cache_j = mj.prefill(pj, {"tokens": jnp.asarray(prompts)},
                            max_len=max_len)
    _, cache_t = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                            max_len=max_len)
    tok = rng.integers(0, cfg_j.vocab_size, (b, 1))
    _, cache_j = mj.decode_step(pj, jnp.asarray(tok), cache_j, jnp.int32(s))
    _, cache_t = mt.decode_step(pt, torch.from_numpy(tok), cache_t, s)
    kj, vj = cache_j[0][0], cache_j[1][0]
    kt, vt = cache_t[0][0], cache_t[1][0]
    np.testing.assert_allclose(_np(kt), _np(kj), **tol)
    np.testing.assert_allclose(_np(vt), _np(vj), **tol)
    qj = _layer0(jlayers.embed(jnp.asarray(tok), pj["embed"]), pj0, cfg_j,
                 jnp.asarray([s]), jlayers, jattn)[0]
    qt = _layer0(tlayers.embed(torch.from_numpy(tok), pt["embed"]), pt0,
                 cfg_t, torch.tensor([s]), tlayers, tattn)[0]
    exp = jops.flash_decode(_flat(qj), _flat(kj), _flat(vj), jnp.int32(s),
                            block_k=8)
    got = tops.flash_decode(_flat(qt), _flat(kt), _flat(vt), s)
    own = _flat(tattn.decode_attention(qt, kt, vt, pos=s))
    assert got.shape == (b * cfg_t.num_heads, 1, cfg_t.resolved_head_dim)
    np.testing.assert_allclose(_np(got), _np(exp), **tol)
    np.testing.assert_allclose(_np(own), _np(got), **tol)


def test_cpu_wrappers_run_the_plain_versions_without_a_launch():
    (_, _, _), (q, k, v) = _inputs(9, [(3, 20, 16), (3, 13, 16),
                                       (3, 13, 16)], "float32")
    tops.reset_launches()
    for causal in (True, False):
        assert torch.equal(tops.flash_attention(q, k, v, causal=causal),
                           flash_attention_plain(q, k, v, causal))
    for pos in (0, 5, 12, 30, torch.tensor(7)):
        assert torch.equal(tops.flash_decode(q[:, :1], k, v, pos),
                           flash_decode_plain(q[:, :1], k, v, pos))
    assert tops.LAUNCHES["flash_attention"] == 0
    assert tops.LAUNCHES["flash_decode"] == 0


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 16, "tensor_core"), ("bfloat16", 64, "tensor_core"),
    ("bfloat16", 128, "tensor_core"), ("bfloat16", 256, "tensor_core"),
    ("bfloat16", 3, "simt"), ("bfloat16", 24, "simt"),
    ("bfloat16", 100, "simt"), ("float32", 3, "simt"),
    ("float32", 64, "simt"), ("float32", 128, "simt"),
    ("float32", 256, "simt")])
def test_route_sends_bf16_on_the_16_grid_to_the_tensor_cores(dtype, d, want):
    assert route(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("s,t", [(96, 64), (64, 96)])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_plain_matches_jax_bf16_wide_heads(s, t, d):
    """bf16 at the tensor-core route's widest heads, causal with S > T and
    S < T. S and T are multiples of the JAX blocks (32), so the JAX wrapper
    pads no key. Tolerance 5e-2, the reference tests' bf16 one: ``ref`` and
    the plain version round the normalised p to bf16, the Pallas kernel the
    unnormalised one, which moves an output by a few bf16 ulps."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        s * t + d, [(2, s, d), (2, t, d), (2, t, d)], "bfloat16")
    got = flash_attention_plain(tq, tk, tv, causal=True)
    assert got.shape == (2, s, d) and got.dtype == torch.bfloat16
    for exp in (jref.flash_attention_ref(jq, jk, jv, causal=True),
                jops.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                     block_k=32)):
        np.testing.assert_allclose(_np(got), _np(exp), **_tol("bfloat16"))
