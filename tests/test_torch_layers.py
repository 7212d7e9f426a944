"""Port parity for layers and GQA attention: the same numpy inputs through
the JAX reference and the port, float32, atol 1e-5 (the same arithmetic
summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override
from repro.configs import get_smoke_config
from repro.models import attention as jatt
from repro.models import layers as jl
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, exp, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               **(tol or TOL))


def test_rms_norm_matmul_and_embeddings():
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, 5, 16))
    scale = _rand(rng, (16,), 0.1)
    _close(tl.rms_norm(_t(x), _t(scale), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    # zero scales are the identity scale: (1 + scale)
    _close(tl.rms_norm(_t(x), torch.zeros(16)),
           jl.rms_norm(jnp.asarray(x), jnp.zeros(16)))
    w = _rand(rng, (16, 12))
    _close(tl.matmul(_t(x), _t(w)), jl.matmul(jnp.asarray(x), jnp.asarray(w)))
    table = _rand(rng, (40, 16))
    tok = rng.integers(0, 40, (3, 5))
    _close(tl.embed(_t(tok), _t(table)),
           jl.embed(jnp.asarray(tok), jnp.asarray(table)))
    for tied, head in ((True, table), (False, table.T.copy())):
        got = tl.unembed(_t(x), _t(head), tied)
        assert got.dtype == torch.float32
        _close(got, jl.unembed(jnp.asarray(x), jnp.asarray(head), tied))


def test_rope_is_split_half():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 8))
    pos = np.arange(5, 12)
    _close(tl.apply_rope(_t(x), _t(pos), 10000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    _close(tl.rope_freqs(8, 1e6), jl.rope_freqs(8, 1e6))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_hidden_and_ffn(activation):
    rng = np.random.default_rng(2)
    x = _rand(rng, (9, 16))
    names = ("wg", "wu") if activation != "gelu" else ("wi",)
    p = {n: _rand(rng, (16, 24), 0.3) for n in names}
    p["wd"] = _rand(rng, (24, 16), 0.2)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    _close(tl.ffn_hidden(_t(x), pt, activation),
           jl.ffn_hidden(jnp.asarray(x), pj, activation))
    _close(tl.ffn(_t(x), pt, activation), jl.ffn(jnp.asarray(x), pj,
                                                 activation))


def test_gelu_is_the_tanh_form():
    v = torch.linspace(-4, 4, 33)
    _close(tl.gelu(v), jax.nn.gelu(jnp.asarray(v.numpy())))


@pytest.mark.parametrize("s,t,kh,chunk,offset", [
    (20, 20, 4, 8, 0),      # padded q and kv chunks, self keys
    (12, 24, 2, 8, 0),      # cache longer than the prompt, GQA 2 kv heads
    (5, 24, 4, 4, 9),       # continuation at a scalar offset
])
def test_chunked_attention(s, t, kh, chunk, offset):
    rng = np.random.default_rng(s + t)
    q = _rand(rng, (2, s, 4, 8))
    k = _rand(rng, (2, t, kh, 8))
    v = _rand(rng, (2, t, kh, 8))
    exp = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offset=offset,
                                 chunk_q=chunk, chunk_kv=chunk)
    got = tatt.chunked_attention(_t(q), _t(k), _t(v), q_offset=offset,
                                 chunk_q=chunk, chunk_kv=chunk)
    _close(got, exp)


@pytest.mark.parametrize("pos,window", [(0, 0), (7, 0), (15, 4)])
def test_decode_attention(pos, window):
    rng = np.random.default_rng(pos)
    q = _rand(rng, (3, 1, 4, 8))
    k = _rand(rng, (3, 16, 2, 8))
    v = _rand(rng, (3, 16, 2, 8))
    exp = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos=pos, window=window)
    got = tatt.decode_attention(_t(q), _t(k), _t(v), pos=pos, window=window)
    _close(got, exp)


def test_gqa_attention_prefill_then_decode_with_cache():
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32",
                   num_kv_heads=2)
    rng = np.random.default_rng(3)
    d, hd, h, kh = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, 2
    p = {"wq": _rand(rng, (d, h, hd), d ** -0.5),
         "wk": _rand(rng, (d, kh, hd), d ** -0.5),
         "wv": _rand(rng, (d, kh, hd), d ** -0.5),
         "wo": _rand(rng, (h, hd, d), (h * hd) ** -0.5),
         "bq": _rand(rng, (h, hd), 0.1), "bk": _rand(rng, (kh, hd), 0.1),
         "bv": _rand(rng, (kh, hd), 0.1)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    b, s, tmax = 2, 6, 10
    x = _rand(rng, (b, s, d))
    ckj = jnp.zeros((b, tmax, kh, hd))
    cache_t = (torch.zeros(b, tmax, kh, hd), torch.zeros(b, tmax, kh, hd))
    oj, (ckj, cvj) = jatt.gqa_attention(
        jnp.asarray(x), pj, cfg, positions=jnp.arange(s),
        kv_cache=(ckj, ckj), cache_pos=jnp.int32(0))
    ot, cache_t = tatt.gqa_attention(_t(x), pt, cfg,
                                     positions=torch.arange(s),
                                     kv_cache=cache_t, cache_pos=0)
    _close(ot, oj)
    _close(cache_t[0], ckj)
    x1 = _rand(rng, (b, 1, d))
    oj, _ = jatt.gqa_attention(jnp.asarray(x1), pj, cfg,
                               positions=jnp.arange(s, s + 1),
                               kv_cache=(ckj, cvj), cache_pos=jnp.int32(s))
    ot, _ = tatt.gqa_attention(_t(x1), pt, cfg,
                               positions=torch.arange(s, s + 1),
                               kv_cache=cache_t, cache_pos=s)
    _close(ot, oj)
