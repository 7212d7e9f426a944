"""The port's three kernels: plain versions against the JAX package's
Pallas kernels (interpret mode, as the JAX tests run them on the CPU), and
the CPU routing of the wrappers. The CUDA kernels themselves are tested on
a GPU in test_torch_cuda.py.

Tolerance 1e-5 (rtol and atol) in float32: the same products summed in
another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.moe_gather import moe_gather_plain
from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain
from repro_torch.kernels.swiglu import swiglu_ffn_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _ffn_weights(rng, d, f, e=None):
    lead = () if e is None else (e,)
    return (_rand(rng, lead + (d, f), d ** -0.5),
            _rand(rng, lead + (d, f), d ** -0.5),
            _rand(rng, lead + (f, d), f ** -0.5))


@pytest.mark.parametrize("t,d,f", [(100, 48, 96), (37, 24, 72)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_swiglu_plain_matches_jax(t, d, f, activation):
    rng = np.random.default_rng(t + f)
    x = _rand(rng, (t, d))
    wg, wu, wd = _ffn_weights(rng, d, f)
    exp = jops.swiglu_ffn(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                          jnp.asarray(wd), activation=activation,
                          block_t=32, block_f=32)
    got = swiglu_ffn_plain(*_t(x, wg, wu, wd), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("e,d,m,nb", [(3, 24, 44, 5), (4, 32, 40, 3)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_moe_gmm_ragged_plain_matches_jax(e, d, m, nb, activation):
    rng = np.random.default_rng(e * 100 + m)
    block_c = tops.RAGGED_BLOCK_CPU
    xp = _rand(rng, (nb * block_c, d))
    owner = rng.integers(0, e, nb).astype(np.int32)
    wg, wu, wd = _ffn_weights(rng, d, m, e)
    exp = jops.moe_gmm_ragged(jnp.asarray(xp), jnp.asarray(owner),
                              jnp.asarray(wg), jnp.asarray(wu),
                              jnp.asarray(wd), activation=activation,
                              block_c=block_c)
    got = moe_gmm_ragged_plain(*_t(xp, owner, wg, wu, wd), activation,
                               block_c)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("t,k,e,d,m", [(5, 3, 4, 24, 44), (2, 2, 3, 32, 40)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_moe_gather_plain_matches_jax(t, k, e, d, m, activation):
    rng = np.random.default_rng(t * 10 + m)
    xf = _rand(rng, (t, d))
    eidx = rng.integers(0, e, t * k).astype(np.int32)
    eidx[1::3] = e                                    # sentinel assignments
    wg, wu, wd = _ffn_weights(rng, d, m, e)
    exp = jops.moe_gather(jnp.asarray(xf), jnp.asarray(eidx), jnp.asarray(wg),
                          jnp.asarray(wu), jnp.asarray(wd), top_k=k,
                          activation=activation)
    got = moe_gather_plain(*_t(xf, eidx, wg, wu, wd), top_k=k,
                           activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    dead = torch.from_numpy(eidx == e)
    assert dead.any() and (got[dead] == 0).all()


def test_wrappers_route_cpu_tensors_to_plain_without_counting():
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 5, 16))
    wg, wu, wd = _ffn_weights(rng, 16, 24)
    bg, bu, bd = _ffn_weights(rng, 16, 24, 3)
    tops.reset_launches()
    y = tops.swiglu_ffn(*_t(x, wg, wu, wd))
    assert y.shape == (2, 5, 16)
    np.testing.assert_array_equal(
        y.reshape(10, 16).numpy(),
        swiglu_ffn_plain(*_t(x.reshape(10, 16), wg, wu, wd)).numpy())
    ids = torch.tensor([0, 2, 7, 1], dtype=torch.int64)   # 7 clamps to E=3
    g = tops.moe_gather(torch.from_numpy(x[0, :2]), ids, *_t(bg, bu, bd),
                        top_k=2)
    assert (g[2] == 0).all()
    xp = torch.from_numpy(_rand(rng, (32, 16)))
    own = torch.tensor([2, 0], dtype=torch.int32)
    r = tops.moe_gmm_ragged(xp, own, *_t(bg, bu, bd), block_c=16)
    assert r.shape == (32, 16)
    assert tops.LAUNCHES == {"swiglu_ffn": 0, "moe_gmm_ragged": 0,
                             "moe_gather": 0}
