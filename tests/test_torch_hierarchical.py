"""Port parity for hierarchical CMoE (paper §4.4): each routed expert of
deepseek-v2 split into shared and routed sub-experts with its own
analytical sub-router. The deepseek-v2 smoke config in float32; the same
weights and inputs go through the JAX reference (its plain path: the
hierarchical FFN reaches no Pallas kernel on the CPU) and through the port.

Exact partitions need bitwise-equal k-means distances, so the leaf-for-leaf
comparison uses m' = 16, a power of two (see tests/test_torch_convert.py).
At S3A3E8 (m' = 12) the converted model is compared on seed 0 with the
serving CLI's 4 x 128 calibration batch, where no k-means tie occurs (with
a 2 x 64 batch, many binary activation columns tie and the packages'
last-bit differences split them either way)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE, override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core import experts as jex
from repro.core import hierarchical as jh
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import experts as tex
from repro_torch.core import hierarchical as th
from repro_torch.core.partition import partition_neurons
from repro_torch.data import make_calibration_batch
from repro_torch.models import build_model
from repro_torch.models.model import tree_map

ARCH = "deepseek-v2-236b"
# m' = 96 / 6 = 16: exact partitions; S3A3E8 (m' = 12): the CLI's tag
CM16 = dict(num_experts=6, num_shared=2, top_k=2, assignment="jv")
CM = dict(num_experts=8, num_shared=3, top_k=3, assignment="jv")
# hierarchical FFN against JAX on the same params: the same f32 products
# summed in another order
FFN_TOL = dict(atol=1e-5, rtol=0)


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


@pytest.fixture(scope="module")
def conv():
    """One JAX model (seed 0), converted by both packages at m' = 16 and
    by JAX at S3A3E8, on the CLI's 4 x 128 calibration batch."""
    cfg_j = joverride(j_smoke(ARCH), dtype="float32")
    mj = jbuild(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    calib = make_calibration_batch(cfg_j.vocab_size, 4, 128, seed=0)
    jcal = {"tokens": jnp.asarray(calib["tokens"])}
    tcal = {"tokens": torch.as_tensor(calib["tokens"])}
    host = jax.device_get(pj)
    cfg_t = override(get_smoke_config(ARCH), dtype="float32")
    mt = build_model(cfg_t, use_kernel=True, device="cpu")
    out = {"mj": mj, "pj": pj, "mt": mt, "host": host, "jcal": jcal,
           "tcal": tcal, "taps": mt.ffn_inputs(
               params_from_jax_numpy(host, "cpu"), tcal).numpy()}
    for tag, kw in (("16", CM16), ("s3", CM)):
        out["j" + tag] = jh.convert_moe_model(mj, pj, jcal, JCMoE(**kw))
    out["t16"] = th.convert_moe_model(
        mt, params_from_jax_numpy(host, "cpu"), tcal, CMoEConfig(**CM16))
    return out


def _port_cfg(jcfg):
    """The port's config for a converted JAX config."""
    return override(get_smoke_config(ARCH), dtype="float32",
                    cmoe=CMoEConfig(**dataclasses.asdict(jcfg.cmoe)))


# ------------------------------------------------------------- conversion

def test_convert_expert_matches_jax(conv):
    """One expert: the same partition and the same sub-expert leaves."""
    host = conv["host"]
    x = conv["taps"][1].reshape(-1, 64)
    ei = 5
    w = {n: host["blocks"]["moe"][n][1, ei] for n in ("wg", "wu", "wd")}
    cj, pj = jh.convert_expert(*(jnp.asarray(w[n]) for n in ("wg", "wu",
                                                              "wd")),
                               jnp.asarray(x), JCMoE(**CM16), "swiglu")
    ct, pt = th.convert_expert(*(torch.from_numpy(np.array(w[n]))
                                 for n in ("wg", "wu", "wd")),
                               torch.from_numpy(x), CMoEConfig(**CM16),
                               "swiglu")
    for name in ("shared_idx", "routed_idx", "rep_idx"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    for path, leaf in _leaves(jax.device_get(cj)):
        got = ct
        for k in path:
            got = got[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_convert_moe_model_matches_jax(conv):
    """The whole model at m' = 16: every converted leaf exactly JAX's, the
    top level kept without its routed banks, and the report's counts."""
    _, pj2, rj = conv["j16"]
    mt2, pt2, rt = conv["t16"]
    jb = jax.device_get(pj2["blocks"])
    n = 0
    for path, leaf in _leaves(jb):
        got = pt2["blocks"]
        for k in path:
            got = got[k]
        assert tuple(got.shape) == leaf.shape, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
        n += 1
    assert n == sum(1 for _ in _leaves(pt2["blocks"]))
    assert sorted(pt2["blocks"]["moe"]) == sorted(jb["moe"])
    assert (rt.num_layers, rt.num_experts) == (rj.num_layers,
                                               rj.num_experts)
    assert mt2.cfg.cmoe == CMoEConfig(**CM16)
    # each layer's converted banks are contiguous, as the kernels take them
    for li in range(rt.num_layers):
        for part in ("shared", "routed"):
            for w in pt2["blocks"]["cmoe"][part].values():
                assert w[li].is_contiguous()


def test_conversion_takes_over_the_expert_banks(conv):
    """The converted banks reuse the originals' storage and the caller's
    params give their banks up, so no stale copy can be served."""
    params = params_from_jax_numpy(conv["host"], "cpu")
    ptr = params["blocks"]["moe"]["wg"].data_ptr()
    _, p2, _ = th.convert_moe_model(conv["mt"], params, conv["tcal"],
                                    CMoEConfig(**CM16))
    assert "wg" not in params["blocks"]["moe"]
    assert p2["blocks"]["cmoe"]["shared"]["wg"].data_ptr() == ptr


def test_partition_pool_matches_serial_loop(conv):
    """The thread pool's partitions are the serial loop's, bit for bit."""
    host = conv["host"]
    x = torch.from_numpy(conv["taps"][0].reshape(-1, 64))
    cm = CMoEConfig(**CM)
    profiles = []
    for ei in range(8):
        w = {n: torch.from_numpy(np.array(host["blocks"]["moe"][n][0, ei]))
             for n in ("wg", "wu", "wd")}
        profiles.append(th.profile_expert(w, x, cm, "swiglu"))
    pooled = th.partition_profiles(profiles, cm)
    for (a, mu), got in zip(profiles, pooled):
        want = partition_neurons(a, mu, cm)
        for name in ("shared_idx", "routed_idx", "rep_idx"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        np.testing.assert_array_equal(got.cluster.centroids,
                                      want.cluster.centroids)


def test_converted_config_without_converted_block_raises():
    """A CMoE config on unconverted MoE blocks is refused, never served as
    the plain MoE under a conversion tag."""
    cfg = override(get_smoke_config(ARCH), dtype="float32")
    model = build_model(cfg.with_cmoe(CMoEConfig(**CM)), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no converted experts"):
        model.prefill(params, {"tokens": torch.zeros((1, 4),
                                                     dtype=torch.long)})


# ---------------------------------------------------------------- runtime

def _ffn_case(conv, phase, variant, seed=5):
    """Layer 0 of JAX's S3A3E8 conversion with a random balance bias,
    sub-level bias and u (the conversion leaves them zero), and inputs."""
    mj2, pj2, _ = conv["js3"]
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a[0]), jax.device_get(pj2["blocks"]))
    p["moe"]["balance_bias"] = rng.normal(0, 0.05, 8).astype(np.float32)
    p["cmoe"]["bias"] = rng.normal(0, 0.05, (8, 5)).astype(np.float32)
    p["cmoe"]["u"] = rng.normal(0, 0.5, (8, 5)).astype(np.float32)
    b, s = (2, 12) if phase == "prefill" else (7, 1)
    x = rng.normal(0, 1, (b, s, 64)).astype(np.float32)
    valid = k_row = None
    if variant == "valid":
        valid = rng.random((b * s, 1)) > 0.3
        valid[0] = True
    if variant == "tiers":
        k_row = rng.integers(1, 4, b * s).astype(np.int32)
    return mj2.cfg, p, x, valid, k_row


# the reference FFN, compiled (eager dispatch is ~5x slower), once per
# (phase, variant) under its own backend policy (grouped at prefill, gather
# at decode), which every port backend is held against
_JAX_FFN = jax.jit(jh.hierarchical_moe_ffn, static_argnames=("cfg", "phase"))
_JAX_OUT: dict = {}


def _both(conv, backend, phase, variant):
    cfg_j, p, x, valid, k_row = _ffn_case(conv, phase, variant)
    jv = None if valid is None else jnp.asarray(valid)
    jk = None if k_row is None else jnp.asarray(k_row)
    if (phase, variant) not in _JAX_OUT:
        _JAX_OUT[phase, variant] = _JAX_FFN(
            jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg=cfg_j,
            phase=phase, valid=jv, k_row=jk)
    oj, auxj = _JAX_OUT[phase, variant]
    tv = None if valid is None else torch.from_numpy(valid)
    tk = None if k_row is None else torch.from_numpy(k_row)
    pt = params_from_jax_numpy(p, "cpu")
    ot, auxt = th.hierarchical_moe_ffn(
        torch.from_numpy(x), pt, _port_cfg(cfg_j),
        use_kernel=backend != "grouped_plain", backend=backend,
        phase=phase, valid=tv, k_row=tk)
    return (oj, auxj), (ot, auxt), pt, (x, tv, tk)


@pytest.mark.parametrize("variant", ["all", "valid", "tiers"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["gather", "grouped_plain",
                                     "grouped_kernel"])
def test_hierarchical_ffn_matches_jax(conv, backend, phase, variant):
    """The two-level FFN on JAX's converted params (carried through the
    bridge): outputs within 1e-5, the same load per expert and router
    means, zero dropped pairs; masked rows and sub-tiers below K_max
    included."""
    (oj, auxj), (ot, auxt), _, (x, _, _) = _both(conv, backend, phase,
                                                 variant)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FFN_TOL)
    # the kept assignments per expert (load x T k: the compiled reference
    # rounds the division its own way)
    pairs = x.shape[0] * x.shape[1] * 2
    np.testing.assert_array_equal(
        np.rint(auxt["load"].numpy() * pairs),
        np.rint(np.asarray(auxj["load"]) * pairs))
    np.testing.assert_allclose(auxt["router_probs_mean"].numpy(),
                               np.asarray(auxj["router_probs_mean"]),
                               **FFN_TOL)
    assert int(auxt["dropped"]) == int(auxj["dropped"]) == 0


@pytest.mark.parametrize("backend", ["gather", "grouped_plain"])
def test_dead_rows_to_sentinel_is_bitwise_neutral(conv, backend,
                                                  monkeypatch):
    """Re-aiming the unoccupied outer rows at the sentinel changes no bit
    of the output (decode, where most outer rows are dead)."""
    _, (ot, _), pt, (x, tv, tk) = _both(conv, backend, "decode", "tiers")
    monkeypatch.setattr(th, "dead_rows_to_sentinel",
                        lambda flat_sub, occ, sentinel: flat_sub)
    cfg = _port_cfg(conv["js3"][0].cfg)
    ref, _ = th.hierarchical_moe_ffn(torch.from_numpy(x), pt, cfg,
                                     use_kernel=backend == "gather",
                                     backend=backend, phase="decode",
                                     k_row=tk)
    assert torch.equal(ot, ref)


@pytest.fixture
def jax_heuristic_policy(monkeypatch):
    """The JAX policy without its measured-crossover file (CPU numbers at
    another bank shape), whose cache is dropped on the way in and out."""
    monkeypatch.setenv("REPRO_DECODE_BENCH", "")
    jex._reset_measured_crossover()
    yield
    jex._reset_measured_crossover()


JNAMES = {"grouped_xla": "grouped_plain", "grouped_pallas": "grouped_kernel"}


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("t,phase,eff", [
    (1, "decode", None), (4, "decode", 2.0), (1, "prefill", None),
    (128, "prefill", None), (4, "mixed", None), (26, "mixed", 1.0),
    (64, "mixed", 2.5)])
def test_microbatch_backend_matches_jax(t, phase, eff, full,
                                        jax_heuristic_policy):
    """The hierarchical policy is made on the outer layout's rows against
    the flattened sub-expert bank, as the reference makes it."""
    from repro.configs import get_config as j_get
    cfg_j = j_get(ARCH) if full else j_smoke(ARCH)
    cfg_j = cfg_j.with_cmoe(JCMoE(**CM))
    cfg_t = (get_config(ARCH) if full else get_smoke_config(ARCH)
             ).with_cmoe(CMoEConfig(**CM))
    for use_kernel in (False, True):
        want = jex.microbatch_backend(cfg_j, t, phase, use_kernel=use_kernel,
                                      effective_k=eff)
        got = tex.microbatch_backend(cfg_t, t, phase, use_kernel=use_kernel,
                                     effective_k=eff)
        assert got == JNAMES.get(want, want)


# ------------------------------------------------------------ whole model

def test_converted_model_matches_jax(conv):
    """JAX's S3A3E8 conversion carried through the bridge: prefill logits
    within 1e-4 of max|logit| and the static greedy loop's tokens equal;
    and the port's own conversion of the same weights gives JAX's leaves
    (seed 0 with the 4 x 128 batch has no k-means tie)."""
    mj2, pj2, _ = conv["js3"]
    mt2 = build_model(_port_cfg(mj2.cfg), use_kernel=True, device="cpu")
    pt2 = params_from_jax_numpy(jax.device_get(pj2), "cpu")
    _, own, _ = th.convert_moe_model(
        conv["mt"], params_from_jax_numpy(conv["host"], "cpu"),
        conv["tcal"], CMoEConfig(**CM))
    for path, leaf in _leaves(pt2["blocks"]["cmoe"]):
        got = own["blocks"]["cmoe"]
        for k in path:
            got = got[k]
        assert torch.equal(got, leaf), path
    tok = np.random.default_rng(3).integers(0, 256, (2, 10))
    prefill = jax.jit(mj2.prefill, static_argnames=("max_len",))
    decode = jax.jit(mj2.decode_step)
    lj, cj = prefill(pj2, {"tokens": jnp.asarray(tok)}, max_len=16)
    lt, ct = mt2.prefill(pt2, {"tokens": torch.as_tensor(tok)}, max_len=16)
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj,
                               atol=1e-4 * np.abs(lj).max(), rtol=0)
    tj, tt = [np.argmax(lj, -1)], [torch.argmax(lt, -1)]
    assert tt[0].tolist() == tj[0].tolist()
    for i in range(4):
        lj, cj = decode(pj2, jnp.asarray(tj[-1])[:, None], cj,
                        jnp.int32(10 + i))
        lt, ct = mt2.decode_step(pt2, tt[-1][:, None], ct, 10 + i)
        tj.append(np.argmax(np.asarray(lj), -1))
        tt.append(torch.argmax(lt, -1))
        assert tt[-1].tolist() == tj[-1].tolist()


def test_all_active_conversion_is_exact():
    """S3A5E8 activates every sub-expert: the converted model's hidden
    states equal the unconverted model's within the reference test's
    atol 1e-4, rtol 1e-3."""
    cfg = override(get_smoke_config(ARCH), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)))}
    h1 = model.hidden_states(params, batch)
    calib = make_calibration_batch(cfg.vocab_size, 2, 64, seed=3)
    m2, p2, _ = th.convert_moe_model(
        model, tree_map(torch.clone, params),
        {"tokens": torch.as_tensor(calib["tokens"])},
        CMoEConfig(num_experts=8, num_shared=3, top_k=5, k_activation=4,
                   assignment="jv"))
    h2 = m2.hidden_states(p2, batch)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-4, rtol=1e-3)
