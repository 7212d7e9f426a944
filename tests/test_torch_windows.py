"""Per-layer sliding windows: gemma3's smoke config (six layers, window 16,
one global layer per five local ones) in the port against the JAX package
on the CPU, float32, one set of JAX params carried by the bridge.

The port config here is the reference's smoke config field for field
(tests/test_torch_dense_archs.py holds the registry's copy equal to it). Logits agree within 1e-5 of
max|logit| over 2 x 48 tokens (three windows deep) through Model.forward,
and through a prefill with 4 decode steps on a contiguous cache; a paged
engine run gives identical greedy streams. ``layer_windows`` itself equals
the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as jbuild
from repro.models.model import layer_windows as j_layer_windows
from repro.serving import ServingEngine as JEngine
from repro.serving import make_requests as j_make_requests
from repro_torch import config as tconfig
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.models import build_model
from repro_torch.models.model import layer_windows
from repro_torch.serving import ServingEngine, make_requests

ARCH = "gemma3-4b"
B, S, STEPS = 2, 48, 4


def _port_cfg(jcfg):
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    assert all(fields[n] is None for n in ("moe", "mla", "cmoe", "ssm"))
    return tconfig.ModelConfig(**fields)


@pytest.fixture(scope="module")
def gemma3():
    cfg_j = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    assert cfg_j.local_global_ratio == 5 and cfg_j.sliding_window == 16
    cfg_t = _port_cfg(cfg_j)
    pj = jax.device_get(jax.jit(jbuild(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, cfg_t, pj, params_from_jax_numpy(pj, "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("smoke", [True, False])
def test_layer_windows_matches_jax(smoke):
    cfg_j = j_smoke(ARCH) if smoke else j_config(ARCH)
    got = layer_windows(_port_cfg(cfg_j))
    assert got == np.asarray(j_layer_windows(cfg_j)).tolist()
    assert 0 in got and cfg_j.sliding_window in got


def test_gemma3_forward_matches_jax(gemma3):
    cfg_j, cfg_t, pj, pt = gemma3
    tok = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (B, S))
    want = jax.jit(jbuild(cfg_j).forward)(pj, {"tokens": jnp.asarray(tok)})
    got = build_model(cfg_t, device="cpu").forward(
        pt, {"tokens": torch.from_numpy(tok)})
    _close(got.numpy(), want)


def test_gemma3_prefill_and_decode_match_jax(gemma3):
    """The static path: chunked prefill into a contiguous cache, then decode
    steps whose keys reach past the window; both packages are fed JAX's
    greedy tokens."""
    cfg_j, cfg_t, pj, pt = gemma3
    mj = jbuild(cfg_j)
    mt = build_model(cfg_t, device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S))
    lj, cj = jax.jit(lambda p, t: mj.prefill(p, {"tokens": t},
                                              max_len=S + STEPS))(
        pj, jnp.asarray(tok))
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)},
                        max_len=S + STEPS)
    _close(lt.numpy(), lj)
    decode_j = jax.jit(mj.decode_step)
    for i in range(STEPS):
        nxt = np.array(jnp.argmax(lj, -1))[:, None]
        lj, cj = decode_j(pj, jnp.asarray(nxt), cj, jnp.int32(S + i))
        lt, ct = mt.decode_step(pt, torch.from_numpy(nxt), ct, S + i)
        _close(lt.numpy(), lj)


def test_gemma3_paged_engine_matches_jax(gemma3):
    """The engine over paged blocks of 8 (overlapped, chunked prefill):
    prompts of 20-40 tokens decode past the window on local layers and
    over the whole prompt on the global one."""
    cfg_j, cfg_t, pj, pt = gemma3
    kw = dict(max_slots=3, max_len=48, max_prefill_tokens=16, paged=True,
              block_size=8, overlap=True)
    args = (5, cfg_t.vocab_size)
    req_kw = dict(prompt_range=(20, 40), gen_range=(4, 8), rate=0.5, seed=2)
    rep_j = JEngine(jbuild(cfg_j), jax.device_put(pj), **kw).run(
        j_make_requests(*args, **req_kw))
    mt = build_model(cfg_t, use_kernel=True, device="cpu")
    rep_t = ServingEngine(mt, pt, **kw).run(make_requests(*args, **req_kw))
    want = {r.rid: tuple(r.generated) for r in rep_j.requests}
    got = {r.rid: tuple(r.generated) for r in rep_t.requests}
    assert got == want
    assert all(r.done for r in rep_t.requests) and rep_t.pool_audit["ok"]
