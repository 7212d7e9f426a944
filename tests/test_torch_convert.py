"""Port parity for the conversion: the calibration taps, the partition, the
parameter slicing, Sinkhorn and the reconstruction error, against the JAX
reference on the same numbers.

Exact partitions need bitwise-equal k-means distances. Centroids are means
of m binary columns, so with m a power of two every distance is a sum of
dyadic numbers, exact in float32 in any summation order, and both packages
see the same distances; those cases must match exactly. (With other m the
last bit of a distance depends on the order in which XLA or PyTorch sums,
and a tie between two assignments can split either way.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig, override
from repro.configs import get_smoke_config
from repro.core import clustering as jclu
from repro.core import convert as jconv
from repro.core import partition as jpart
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import clustering as tclu
from repro_torch.core import convert as tconv
from repro_torch.core import partition as tpart
from repro_torch.core import profiling as tprof
from repro_torch.data import make_calibration_batch
from repro_torch.models import build_model as tbuild

CALIB = dict(num_samples=2, seq_len=64)


def _models(arch, seed=0):
    cfg_j = override(get_smoke_config(arch), dtype="float32")
    cfg_t = override(t_smoke(arch), dtype="float32")
    mj = jbuild(cfg_j)
    pj = mj.init(jax.random.PRNGKey(seed))
    mt = tbuild(cfg_t, device="cpu")
    pt = params_from_jax_numpy(jax.device_get(pj), "cpu")
    tok = make_calibration_batch(cfg_j.vocab_size, seed=seed, **CALIB)
    return mj, pj, mt, pt, tok["tokens"]


def _profiles(arch, seed, k_activation=10):
    """Per-layer (a, mu) from the port's profiling of JAX's taps, plus the
    JAX model pieces."""
    mj, pj, mt, pt, tok = _models(arch, seed)
    taps = np.asarray(mj.ffn_inputs(pj, {"tokens": jnp.asarray(tok)}))
    out = []
    for li in range(taps.shape[0]):
        ffn = jax.tree.map(lambda a: a[li], pj["blocks"]["ffn"])
        h = jconv.ffn_hidden(jnp.asarray(taps[li].reshape(-1, taps.shape[-1])),
                             ffn, mj.cfg.activation)
        a, mu = tprof.profile_hidden(torch.from_numpy(np.array(h)),
                                     k_activation)
        out.append((a.numpy(), mu.numpy(), ffn))
    return mj, pj, mt, pt, tok, taps, out


def test_calibration_taps_match():
    mj, pj, mt, pt, tok = _models("qwen1.5-0.5b")
    taps_j = np.asarray(mj.ffn_inputs(pj, {"tokens": jnp.asarray(tok)}))
    taps_t = mt.ffn_inputs(pt, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(taps_t.numpy(), taps_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,cm", [
    ("qwen1.5-0.5b", CMoEConfig(num_experts=11, num_shared=3, top_k=3)),
    ("qwen1.5-0.5b", CMoEConfig(num_experts=22, num_shared=6, top_k=4)),
    ("llama2-7b", CMoEConfig(num_experts=12, num_shared=4, top_k=2))])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_and_params_exactly_equal(arch, cm, seed):
    _, _, _, _, _, _, layers = _profiles(arch, seed)
    for a, mu, ffn in layers:
        want = jpart.partition_neurons(a, mu, cm)
        got = tpart.partition_neurons(a, mu, cm)
        for key in ("shared_idx", "routed_idx", "rep_idx"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(want, key), err_msg=key)
        pj = jpart.build_cmoe_params(ffn, want, cm, "swiglu")
        pt = tpart.build_cmoe_params(
            params_from_jax_numpy(jax.device_get(ffn), "cpu"), got, cm,
            "swiglu")
        flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(pj))
        for path, leaf in flat_j:
            node = pt
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                          err_msg=str(path))


def test_sinkhorn_plan_matches_jax():
    rng = np.random.default_rng(0)
    dist = rng.random((60, 4)).astype(np.float32)
    want = np.asarray(jclu.sinkhorn_plan(jnp.asarray(dist), 15, 0.05, 100))
    got = tclu.sinkhorn_plan(torch.from_numpy(dist), 15, 0.05, 100).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-4)
    np.testing.assert_array_equal(tclu.round_plan_greedy(got, 15),
                                  jclu.round_plan_greedy(want, 15))


def test_reconstruction_error_matches_jax():
    """The JAX conversion carried through the bridge gives the same
    reconstruction error in both packages."""
    cm = CMoEConfig(num_experts=8, num_shared=3, top_k=3)
    mj, pj, mt, pt, tok = _models("qwen1.5-0.5b")
    batch_j = {"tokens": jnp.asarray(tok)}
    cmj, cpj, _ = jconv.convert_dense_model(mj, pj, batch_j, cm)
    cmt = tbuild(mt.cfg.with_cmoe(cm), device="cpu")
    cpt = params_from_jax_numpy(jax.device_get(cpj), "cpu")
    batch_t = {"tokens": torch.from_numpy(tok).long()}
    want = jconv.reconstruction_error(mj, pj, cmj, cpj, batch_j)
    got = tconv.reconstruction_error(mt, pt, cmt, cpt, batch_t)
    assert got == pytest.approx(want, rel=1e-4)
