"""Port parity for the router, ATopK profiling, the routed-expert engine and
the CMoE FFN: the same numpy inputs through the JAX reference and the port,
float32, atol 1e-5 (the same arithmetic summed in another order). Ties in
top-k must go to the lower index, as jax.lax.top_k breaks them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig, override
from repro.configs import get_smoke_config
from repro.core import experts as jex
from repro.core import moe_ffn as jmoe
from repro.core import profiling as jprof
from repro.core import router as jr
from repro_torch.core import experts as tex
from repro_torch.core import moe_ffn as tmoe
from repro_torch.core import profiling as tprof
from repro_torch.core import router as tr
from repro_torch.models.model import tree_map

TOL = dict(rtol=1e-5, atol=1e-5)
CM = CMoEConfig(num_experts=8, num_shared=3, top_k=3)


def _cfg():
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    return cfg.with_cmoe(CM)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cmoe_params(rng, d=64, m=22, n_r=5, ms=66):
    return {"shared": {"wg": _rand(rng, (d, ms), d ** -0.5),
                       "wu": _rand(rng, (d, ms), d ** -0.5),
                       "wd": _rand(rng, (ms, d), ms ** -0.5)},
            "routed": {"wg": _rand(rng, (n_r, d, m), d ** -0.5),
                       "wu": _rand(rng, (n_r, d, m), d ** -0.5),
                       "wd": _rand(rng, (n_r, m, d), m ** -0.5)},
            "router": {"wg_r": _rand(rng, (d, n_r), d ** -0.5),
                       "wu_r": _rand(rng, (d, n_r), d ** -0.5)},
            "u": _rand(rng, (n_r,), 0.5), "bias": _rand(rng, (n_r,), 0.01)}


def _jtree(p):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in p.items()}


def _ttree(p):
    return tree_map(_t, p)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_router_scores(activation):
    rng = np.random.default_rng(0)
    x = _rand(rng, (11, 64))
    p = _cmoe_params(rng)["router"]
    np.testing.assert_allclose(
        tr.router_scores(_t(x), _ttree(p), activation).numpy(),
        np.asarray(jr.router_scores(jnp.asarray(x), _jtree(p), activation)),
        **TOL)


def test_cmoe_gate_ties_go_to_the_lower_index():
    # rows of exactly tied scores: every ordering decision is a tie
    scores = np.array([[1.0, 1.0, 1.0, 1.0, 1.0],
                       [0.5, 2.0, 0.5, 2.0, 0.5],
                       [3.0, 1.0, 1.0, 3.0, 1.0],
                       [0.0, 0.0, 7.0, 0.0, 0.0]], np.float32)
    k_row = np.array([3, 2, 1, 3], np.int32)
    u = np.array([0.1, -0.2, 0.3, 0.0, 0.5], np.float32)
    for kw in ({}, {"k_row": k_row}, {"u": u, "bias": np.zeros(5, np.float32)}):
        gj, ij, pj = jr.cmoe_gate(jnp.asarray(scores), 3,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
        gt, it, pt = tr.cmoe_gate(_t(scores), 3,
                                  **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    # the sentinel id N_r marks invalidated columns and is dropped by load
    _, it, _ = tr.cmoe_gate(_t(scores), 3, k_row=_t(k_row))
    assert (it == 5).sum() == 3
    keep = torch.ones_like(it, dtype=torch.bool)
    np.testing.assert_allclose(
        tr.expert_load(it, keep, 5).numpy(),
        np.asarray(jr.expert_load(jnp.asarray(it.numpy()),
                                  jnp.ones(it.shape, bool), 5)), **TOL)


def test_atopk_ties_go_to_the_lower_index():
    rng = np.random.default_rng(1)
    # |h| quantized to a few levels, with sign flips: ties everywhere
    h = (rng.integers(-3, 4, (40, 64)) * 0.25).astype(np.float32)
    aj, muj = jprof.profile_hidden(jnp.asarray(h), 10)
    at, mut = tprof.profile_hidden(_t(h), 10)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(mut.numpy(), np.asarray(muj))
    assert (at.sum(1) == 10).all()


BACKEND_PAIRS = [("exact", "exact"), ("gather", "gather"),
                 ("grouped_plain", "grouped_xla"),
                 ("grouped_kernel", "grouped_pallas")]


@pytest.mark.parametrize("tb,jb", BACKEND_PAIRS)
@pytest.mark.parametrize("masked", [False, True])
def test_routed_experts_backends_match_jax(tb, jb, masked):
    cfg = _cfg()
    rng = np.random.default_rng(2)
    t, k, n_r = 13, 3, 5
    xf = _rand(rng, (t, 64))
    w = _cmoe_params(rng)["routed"]
    gates = _rand(rng, (t, k), 0.5) + 1.0
    idx = np.stack([rng.permutation(n_r)[:k] for _ in range(t)]).astype(
        np.int32)
    if masked:
        idx[2, 1:] = n_r                 # per-token k: sentinel assignments
        gates[2, 1:] = 0.0
    valid = (rng.random((t, 1)) < 0.8) if masked else None
    kw = {} if valid is None else {"valid": valid}
    oj, keepj = jex.routed_experts(
        jnp.asarray(xf), _jtree(w), jnp.asarray(gates), jnp.asarray(idx),
        cfg, backend=jb, use_kernel=jb in ("grouped_pallas", "gather"),
        **{k_: jnp.asarray(v) for k_, v in kw.items()})
    ot, keept = tex.routed_experts(
        _t(xf), _ttree(w), _t(gates), _t(idx).long(), cfg, backend=tb,
        use_kernel=tb in ("grouped_kernel", "gather"),
        **{k_: _t(v) for k_, v in kw.items()})
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_array_equal(keept.numpy(), np.asarray(keepj))


@pytest.mark.parametrize("backend", ["grouped_plain", "grouped_kernel",
                                     "gather"])
def test_routed_output_is_bitwise_width_invariant(backend):
    """The same rows through one call and through a 2-way split give
    bitwise the same output: a token's result does not depend on its
    micro-batch."""
    cfg = _cfg()
    rng = np.random.default_rng(3)
    t, k, n_r = 40, 3, 5
    xf = _t(_rand(rng, (t, 64)))
    w = _ttree(_cmoe_params(rng)["routed"])
    gates = _t(_rand(rng, (t, k), 0.5) + 1.0)
    idx = _t(np.stack([rng.permutation(n_r)[:k] for _ in range(t)])).long()
    use_kernel = backend != "grouped_plain"
    whole, _ = tex.routed_experts(xf, w, gates, idx, cfg, backend=backend,
                                  use_kernel=use_kernel)
    parts = [tex.routed_experts(xf[sl], w, gates[sl], idx[sl], cfg,
                                backend=backend, use_kernel=use_kernel)[0]
             for sl in (slice(0, 17), slice(17, t))]
    assert torch.equal(whole, torch.cat(parts))


@pytest.fixture
def jax_heuristic_policy(monkeypatch):
    """The JAX backend policy without its measured-crossover file (CPU
    numbers at another bank shape) is the ~E/k heuristic the port uses.
    The JAX module caches the file's crossover per process, so the cache
    is dropped on the way in and on the way out."""
    monkeypatch.setenv("REPRO_DECODE_BENCH", "")
    jex._reset_measured_crossover()
    yield
    jex._reset_measured_crossover()


@pytest.mark.parametrize("t,phase,want_t,want_j", [
    (32, "prefill", "grouped_plain", "grouped_xla"),
    (4, "prefill", "gather", "gather"),
    (4, "decode", "gather", "gather")])
def test_select_backend_heuristic(t, phase, want_t, want_j,
                                  jax_heuristic_policy):
    cfg = _cfg()
    assert tex.microbatch_backend(cfg, t, phase) == want_t
    assert jex.microbatch_backend(cfg, t, phase) == want_j


@pytest.mark.parametrize("phase,use_kernel", [("prefill", False),
                                              ("prefill", True),
                                              ("decode", True)])
def test_cmoe_ffn_matches_jax(phase, use_kernel):
    cfg = _cfg()
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 12 if phase == "prefill" else 1, 64))
    p = _cmoe_params(rng)
    oj, auxj = jmoe.cmoe_ffn(jnp.asarray(x), _jtree(p), cfg, phase=phase,
                             use_kernel=use_kernel)
    ot, auxt = tmoe.cmoe_ffn(_t(x), _ttree(p), cfg, phase=phase,
                             use_kernel=use_kernel)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for key in ("load", "router_probs_mean"):
        np.testing.assert_allclose(auxt[key].numpy(), np.asarray(auxj[key]),
                                   **TOL)
    assert int(auxt["dropped"]) == int(auxj["dropped"]) == 0


# ------------------------------------------------- pretrained MoE (deepseek)

def _moe_cfgs():
    from repro.configs import get_smoke_config as j_smoke
    from repro_torch.config import override as t_override
    from repro_torch.configs import get_smoke_config as t_smoke
    return (override(j_smoke("deepseek-v2-236b"), dtype="float32"),
            t_override(t_smoke("deepseek-v2-236b"), dtype="float32"))


def _moe_params(rng, d=64, e=8, m=96, ds=192):
    return {"router": _rand(rng, (d, e), d ** -0.5),
            "wg": _rand(rng, (e, d, m), d ** -0.5),
            "wu": _rand(rng, (e, d, m), d ** -0.5),
            "wd": _rand(rng, (e, m, d), m ** -0.5),
            "balance_bias": _rand(rng, (e,), 0.2),
            "shared_wg": _rand(rng, (d, ds), d ** -0.5),
            "shared_wu": _rand(rng, (d, ds), d ** -0.5),
            "shared_wd": _rand(rng, (ds, d), ds ** -0.5)}


def test_moe_gate_matches_jax():
    """Top-k over probs + balance_bias (a bias large enough to change the
    selection), gates from the true probs renormalised; exact ties in the
    selection go to the lower index, as jax.lax.top_k breaks them."""
    from repro.models import moe as jm
    from repro_torch.models import moe as tm
    cfg_j, cfg_t = _moe_cfgs()
    rng = np.random.default_rng(7)
    p = _moe_params(rng)
    p["balance_bias"][[2, 5, 7]] = 0.3
    xf = _rand(rng, (24, 64))
    xf[5] = 0.0            # uniform probs: experts 2, 5 and 7 tie on top
    gj, ij, pj = jm.moe_gate(jnp.asarray(xf), _jtree(p), cfg_j.moe)
    gt, it, pt = tm.moe_gate(_t(xf), _ttree(p), cfg_t.moe)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    unbiased = dict(p, balance_bias=np.zeros(8, np.float32))
    _, i0, _ = tm.moe_gate(_t(xf), _ttree(unbiased), cfg_t.moe)
    assert not torch.equal(i0, it)          # the bias changed the choice
    assert it[5].tolist() == [2, 5]


@pytest.mark.parametrize("backend,masked", [("gather", False),
                                            ("grouped_plain", True),
                                            ("grouped_kernel", False),
                                            ("exact", True)])
def test_moe_ffn_matches_jax(backend, masked):
    """The pretrained-MoE FFN (routed top-k + 2 shared experts) against the
    reference on each engine backend, with padded rows masked out: the
    output, the load per expert and zero dropped pairs."""
    from repro.models import moe as jm
    from repro_torch.models import moe as tm
    cfg_j, cfg_t = _moe_cfgs()
    rng = np.random.default_rng(8)
    p = _moe_params(rng)
    x = _rand(rng, (2, 9, 64))
    valid = (rng.random((18, 1)) < 0.7) if masked else None
    jb = {"grouped_plain": "grouped_xla",
          "grouped_kernel": "grouped_pallas"}.get(backend, backend)
    kw_j = {} if valid is None else {"valid": jnp.asarray(valid)}
    kw_t = {} if valid is None else {"valid": _t(valid)}
    oj, auxj = jm.moe_ffn(jnp.asarray(x), _jtree(p), cfg_j, backend=jb,
                          use_kernel=jb in ("grouped_pallas", "gather"),
                          **kw_j)
    ot, auxt = tm.moe_ffn(_t(x), _ttree(p), cfg_t, backend=backend,
                          use_kernel=backend in ("grouped_kernel", "gather"),
                          **kw_t)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for key in ("load", "router_probs_mean"):
        np.testing.assert_allclose(auxt[key].numpy(), np.asarray(auxj[key]),
                                   **TOL)
    assert int(auxt["dropped"]) == int(auxj["dropped"]) == 0
