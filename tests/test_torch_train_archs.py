"""Port parity for the training loss, arch by arch: ``Model.loss`` (the
sequence-chunked cross-entropy over the layer stack under remat) and
every gradient leaf, against ``jax.value_and_grad`` of the JAX package's
``Model.loss``, for each arch's smoke config in float32.

The same weights (JAX's, carried through the bridge) and the same
numpy-seeded tokens (and the audio family's frames, the VLM family's
patches) go to both. Tolerances: the loss within LOSS_TOL relative, each
gradient leaf within GRAD_TOL of its own max|g| (the same float32 math
summed in another order). A few leaves have a gradient that is zero
analytically, so both packages give rounding noise or exact zeros there:
every balance bias, a pretrained MoE's and a converted CMoE tree's (it
shifts expert selection, never a gate value), and llama4's router (top-1
routing renormalises its one gate to exactly 1).
Those are held to |g| <= ZERO_TOL of the tree's largest gradient in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import override
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ZERO_TOL = 1e-6
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def analytically_zero(cfg, path) -> bool:
    """Leaves whose exact gradient is zero (see the module docstring)."""
    if path[-1] == "balance_bias" or path[-2:] == ("cmoe", "bias"):
        return True
    return path[-2:] == ("moe", "router") and cfg.moe is not None and \
        cfg.moe.top_k == 1


def batches(cfg, seed: int = 0):
    """(JAX batch, port batch) of B sequences of S + 1 tokens, with frames
    or patches N(0, 1) for the audio and VLM families."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.as_tensor(tok).long(),
          **{k: torch.as_tensor(v) for k, v in extra.items()}}
    return jb, tb


def check_loss_and_grads(jmodel, jparams, tmodel, tparams, jb, tb):
    """Loss and every gradient leaf of both packages, held to the module's
    tolerances. Returns the port's (loss, metrics, grads) and JAX's."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True))(jparams)
    (tl, tm), tg = value_and_grad(lambda p: tmodel.loss(p, tb), tparams,
                                  fill=False)
    jl = float(jl)
    assert abs(float(tl) - jl) <= LOSS_TOL * abs(jl), (float(tl), jl)
    jg = jax.device_get(jg)
    top = max(float(np.abs(np.asarray(x)).max()) for x in
              jax.tree.leaves(jg))
    for path, g in _leaves(tg):
        want = np.asarray(_at(jg, path), dtype=np.float32)
        if analytically_zero(tmodel.cfg, path):
            assert np.abs(want).max() <= ZERO_TOL * top, path
            assert g is None or float(g.abs().max()) <= ZERO_TOL * top, path
            continue
        assert g is not None, f"{path}: no gradient"
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * np.abs(want).max(), (path, err)
    assert set(tm) == set(jm)
    if "moe_load" in jm:
        np.testing.assert_allclose(tm["moe_load"].numpy(),
                                   np.asarray(jm["moe_load"]), atol=1e-6,
                                   rtol=0)
    return (tl, tm, tg), (jl, jm, jg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    """Every arch's smoke config: dense, vlm (patch positions masked out),
    moe (llama4's interleaved stack), mla_moe, ssm, hybrid and audio
    (the encoder in the loss). The routed families also return
    moe_load (L, E), equal to JAX's."""
    jcfg = joverride(j_smoke(arch), dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = override(get_smoke_config(arch), dtype="float32")
    tm = build_model(cfg, use_kernel=False, device="cpu")
    tp = params_from_jax_numpy(jax.device_get(jp), "cpu")
    jb, tb = batches(cfg)
    (_, metrics, _), _ = check_loss_and_grads(jm, jp, tm, tp, jb, tb)
    if cfg.family == "moe":
        n_moe = cfg.num_layers // cfg.moe.moe_every
        assert tuple(metrics["moe_load"].shape) == (n_moe,
                                                    cfg.moe.num_experts)
    else:
        assert "moe_load" not in metrics
