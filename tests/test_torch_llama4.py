"""Port parity for llama4's MoE stack: dense and GQA + MoE layers
interleaved (one of each a period), served as it stands and converted
hierarchically (each routed expert split into shared and routed
sub-experts; the dense layers stay dense). The llama4 smoke config in
float32 with its depth overridden to 4 layers (two periods, so the order
of the stack is tested); the same weights (JAX's, carried through the
bridge) and inputs go through the JAX reference (its plain path: nothing
here reaches a Pallas kernel on the CPU) and through the port.

The port keeps llama4's cache as the flat (k, v) pair of L layers in model
order; the reference nests ((k_dense, v_dense), (k_moe, v_moe)) of L/2
layers each. Period i's dense layer is the port's layer 2i and its MoE
layer 2i + 1 (``_nested``).

The smoke experts have 128 neurons, so S3A3E8 and S2A2E8 split them into
sub-experts of m' 16, a power of two: both packages' k-means see the same
float32 distances and give the same partitions (tests/test_torch_convert.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE, override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core import hierarchical as jh
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_smoke_config
from repro_torch.core import hierarchical as th
from repro_torch.data import make_calibration_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.model import init_stacked, tree_map
from repro_torch.serving import Request, ServingEngine, make_requests

ARCH = "llama4-maverick-400b-a17b"
LAYERS = 4
CM = dict(num_experts=8, num_shared=3, top_k=3, assignment="jv")
CM_ALL = dict(num_experts=8, num_shared=3, top_k=5, k_activation=4,
              assignment="jv")
# the same f32 products summed in another order, through 4 layers:
# logits within LOGIT_TOL of max|logit|, FFN inputs within TAP_TOL of
# max|tap| (RMS-normed, up to ~4)
LOGIT_TOL = 1e-5
TAP_TOL = 1e-6


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


def _nested(flat):
    """The port's flat (k, v) of L layers -> the reference's nesting
    ((k_dense, v_dense), (k_moe, v_moe)) of L/2 layers each."""
    return tuple((flat[0][j::2], flat[1][j::2]) for j in (0, 1))


@pytest.fixture(scope="module")
def pair():
    """One JAX model at 4 layers (seed 0), its weights in both packages,
    and the CLI's 4 x 128 calibration batch."""
    cfg_j = joverride(j_smoke(ARCH), dtype="float32", num_layers=LAYERS)
    mj = jbuild(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    host = jax.device_get(pj)
    cfg_t = override(get_smoke_config(ARCH), dtype="float32",
                     num_layers=LAYERS)
    mt = build_model(cfg_t, use_kernel=True, device="cpu")
    calib = make_calibration_batch(cfg_t.vocab_size, 4, 128, seed=0)
    return {"mj": mj, "pj": pj, "host": host, "mt": mt,
            "pt": params_from_jax_numpy(host, "cpu"),
            "jcal": {"tokens": jnp.asarray(calib["tokens"])},
            "tcal": {"tokens": torch.as_tensor(calib["tokens"])}}


def _tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


# ------------------------------------------------------------ the stack

def test_params_are_the_references_layout(pair):
    """init draws the reference's tree: blocks_dense and blocks_moe of L/2
    layers each, the dense layers with a dense FFN, the MoE layers with the
    128-neuron experts and one shared expert."""
    own = pair["mt"].init(torch.Generator().manual_seed(0))
    ref = dict(_leaves(pair["host"]))
    got = dict(_leaves(own))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(got[path].shape) == leaf.shape, path
    assert own["blocks_dense"]["ffn"]["wg"].shape[0] == LAYERS // 2


def test_forward_matches_jax(pair):
    tok = _tokens((2, 16))
    lj = np.asarray(pair["mj"].forward(pair["pj"],
                                       {"tokens": jnp.asarray(tok)}))
    lt = pair["mt"].forward(pair["pt"], {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(lt.numpy(), lj,
                               atol=LOGIT_TOL * np.abs(lj).max(), rtol=0)


def test_ffn_inputs_match_jax(pair):
    """Both taps, each stacked over its own layers, as the reference's
    {"moe", "dense"} dict."""
    tok = _tokens((2, 16), seed=4)
    tj = pair["mj"].ffn_inputs(pair["pj"], {"tokens": jnp.asarray(tok)})
    tt = pair["mt"].ffn_inputs(pair["pt"], {"tokens": torch.as_tensor(tok)})
    assert sorted(tt) == sorted(tj) == ["dense", "moe"]
    for key in ("dense", "moe"):
        assert tuple(tt[key].shape) == (LAYERS // 2, 2, 16, 64)
        want = np.asarray(tj[key])
        np.testing.assert_allclose(tt[key].numpy(), want,
                                   atol=TAP_TOL * np.abs(want).max(), rtol=0)


def test_prefill_and_greedy_decode_match_jax(pair):
    """A prefill into a cache of 16, then 5 greedy tokens, token for
    token; logits within LOGIT_TOL of max|logit| at every step."""
    mj, pj, mt, pt = pair["mj"], pair["pj"], pair["mt"], pair["pt"]
    tok = _tokens((2, 10), seed=5)
    prefill = jax.jit(mj.prefill, static_argnames=("max_len",))
    decode = jax.jit(mj.decode_step)
    lj, cj = prefill(pj, {"tokens": jnp.asarray(tok)}, max_len=16)
    lt, ct = mt.prefill(pt, {"tokens": torch.as_tensor(tok)}, max_len=16)
    tj, tt = [], []
    for i in range(6):
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj,
                                   atol=LOGIT_TOL * np.abs(lj).max(), rtol=0)
        tj.append(np.argmax(lj, -1))
        tt.append(torch.argmax(lt, -1))
        assert tt[-1].tolist() == tj[-1].tolist()
        if i == 5:
            break
        lj, cj = decode(pj, jnp.asarray(tj[-1])[:, None], cj,
                        jnp.int32(10 + i))
        lt, ct = mt.decode_step(pt, tt[-1][:, None], ct, 10 + i)


def _assert_caches_equal(flat, nested):
    got = _nested(flat)
    for part in (0, 1):                          # dense layers, MoE layers
        for leaf in (0, 1):                      # k, v
            want = np.asarray(nested[part][leaf])
            assert tuple(got[part][leaf].shape) == want.shape
            np.testing.assert_allclose(got[part][leaf].numpy(), want,
                                       atol=1e-5, rtol=0)


def test_contiguous_cache_after_prefill_matches_jax(pair):
    tok = _tokens((2, 10), seed=6)
    _, cj = pair["mj"].prefill(pair["pj"], {"tokens": jnp.asarray(tok)},
                               max_len=16)
    _, ct = pair["mt"].prefill(pair["pt"], {"tokens": torch.as_tensor(tok)},
                               max_len=16)
    assert ct[0].shape[0] == LAYERS
    assert bool((ct[0][:, :, 10:] == 0).all())
    _assert_caches_equal(ct, cj)


def test_paged_cache_after_prefill_matches_jax(pair):
    """A per-slot prefill through fragmented block tables (block 0 is the
    trash block): the same pool, block for block."""
    tok = _tokens((2, 10), seed=7)
    tables = np.array([[3, 1, 6], [2, 5, 4]], np.int32)
    cj = pair["mj"].init_paged_cache(7, 4)
    _, cj = pair["mj"].step(pair["pj"], jnp.asarray(tok), cj,
                            jnp.zeros((2,), jnp.int32),
                            block_tables=jnp.asarray(tables))
    ct = pair["mt"].init_paged_cache(7, 4)
    pair["mt"].step(pair["pt"], torch.as_tensor(tok), ct,
                    torch.zeros((2,), dtype=torch.long),
                    block_tables=torch.as_tensor(tables))
    assert bool((ct[0][:, 0] == 0).all())
    _assert_caches_equal(ct, cj)


def test_depth_must_be_whole_periods():
    cfg = override(get_smoke_config(ARCH), dtype="float32", num_layers=3)
    with pytest.raises(ValueError, match="multiple of 2"):
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of 2"):
        tserve.run(["--smoke", "--arch", ARCH, "--device", "cpu",
                    "--layers", "3"])


def test_init_stacked_single_draw_is_a_view():
    """n == 1: the one draw with a leading axis, no copy; the same numbers
    as the first layer of a stack drawn from the same generator state."""
    def make(g):
        return {"w": torch.randn((3, 5), generator=g),
                "b": {"c": torch.randn((4,), generator=g)}}
    g = torch.Generator().manual_seed(1)
    one = init_stacked(lambda: make(g), 1)
    two = init_stacked(lambda: make(torch.Generator().manual_seed(1)), 2)
    for path, leaf in _leaves(one):
        assert leaf.shape[0] == 1 and leaf.is_contiguous()
        assert torch.equal(leaf[0], _at(two, path)[0])


# ------------------------------------------------- hierarchical conversion

@pytest.fixture(scope="module")
def conv(pair):
    """JAX's S3A3E8 conversion of the 4-layer model, and the port's own
    conversion of the same weights."""
    mj2, pj2, rj = jh.convert_moe_model(pair["mj"], pair["pj"],
                                        pair["jcal"], JCMoE(**CM))
    mt2, pt2, rt = th.convert_moe_model(
        pair["mt"], tree_map(torch.clone, pair["pt"]), pair["tcal"],
        CMoEConfig(**CM))
    return {"j": (mj2, pj2, rj), "t": (mt2, pt2, rt)}


def test_interleaved_conversion_matches_jax_leaf_for_leaf(conv):
    """Every leaf of both stacks exactly JAX's: the MoE layers converted
    (the routed banks given up, router, balance bias and shared expert
    kept), the dense layers untouched; the report's counts."""
    _, pj2, rj = conv["j"]
    mt2, pt2, rt = conv["t"]
    host = jax.device_get(pj2)
    n = 0
    for path, leaf in _leaves(host):
        got = _at(pt2, path)
        assert tuple(got.shape) == leaf.shape, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf),
                                      err_msg=str(path))
        n += 1
    assert n == sum(1 for _ in _leaves(pt2))
    assert "cmoe" in pt2["blocks_moe"] and "wg" not in pt2["blocks_moe"]["moe"]
    assert "cmoe" not in pt2["blocks_dense"]
    assert (rt.num_layers, rt.num_experts) == (rj.num_layers,
                                               rj.num_experts) == (2, 8)
    assert mt2.cfg.cmoe == CMoEConfig(**CM)


def test_conversion_takes_over_the_moe_banks(pair):
    params = tree_map(torch.clone, pair["pt"])
    ptr = params["blocks_moe"]["moe"]["wg"].data_ptr()
    _, p2, _ = th.convert_moe_model(pair["mt"], params, pair["tcal"],
                                    CMoEConfig(**CM))
    assert "wg" not in params["blocks_moe"]["moe"]
    assert p2["blocks_moe"]["cmoe"]["shared"]["wg"].data_ptr() == ptr
    assert p2["blocks_dense"] is params["blocks_dense"]


def test_converted_model_matches_jax(conv):
    """JAX's S3A3E8 conversion carried through the bridge: prefill logits
    within LOGIT_TOL of max|logit|, then 5 greedy tokens equal."""
    mj2, pj2, _ = conv["j"]
    mt2 = build_model(conv["t"][0].cfg, use_kernel=True, device="cpu")
    pt2 = params_from_jax_numpy(jax.device_get(pj2), "cpu")
    tok = _tokens((2, 10), seed=8)
    prefill = jax.jit(mj2.prefill, static_argnames=("max_len",))
    decode = jax.jit(mj2.decode_step)
    lj, cj = prefill(pj2, {"tokens": jnp.asarray(tok)}, max_len=16)
    lt, ct = mt2.prefill(pt2, {"tokens": torch.as_tensor(tok)}, max_len=16)
    for i in range(6):
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj,
                                   atol=LOGIT_TOL * np.abs(lj).max(), rtol=0)
        nj, nt = np.argmax(lj, -1), torch.argmax(lt, -1)
        assert nt.tolist() == nj.tolist()
        if i == 5:
            break
        lj, cj = decode(pj2, jnp.asarray(nj)[:, None], cj, jnp.int32(10 + i))
        lt, ct = mt2.decode_step(pt2, nt[:, None], ct, 10 + i)


def test_all_active_conversion_is_exact(pair):
    """S3A5E8 activates every sub-expert: the converted model's hidden
    states equal the unconverted model's within the reference test's
    atol 1e-4, rtol 1e-3."""
    mt, pt = pair["mt"], pair["pt"]
    batch = {"tokens": torch.as_tensor(_tokens((2, 32), seed=4))}
    h1 = mt.hidden_states(pt, batch)
    calib = make_calibration_batch(mt.cfg.vocab_size, 2, 64, seed=3)
    m2, p2, _ = th.convert_moe_model(
        mt, tree_map(torch.clone, pt),
        {"tokens": torch.as_tensor(calib["tokens"])}, CMoEConfig(**CM_ALL))
    h2 = m2.hidden_states(p2, batch)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------- the engine

def _mix(vocab, seed=2, **kw):
    return make_requests(6, vocab, prompt_range=(6, 14), gen_range=(3, 6),
                         rate=0.5, seed=seed, **kw)


def _preempt_mix(vocab, seed=13):
    """A long low-priority request admitted first and a high-priority one
    arriving once it runs, into a pool only one of them fits."""
    rng = np.random.default_rng(seed)
    return [Request(rid=0, prompt=rng.integers(0, vocab, 8).tolist(),
                    max_new=12, priority=0),
            Request(rid=1, prompt=rng.integers(0, vocab, 8).tolist(),
                    max_new=8, priority=1, arrival=4.0)]


def _run(model, params, reqs, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_len", 40)
    kw.setdefault("prefill_bucket", 8)
    rep = ServingEngine(model, params, **kw).run(reqs)
    assert all(r.done for r in rep.requests)
    assert rep.dropped_pairs == 0
    if rep.pool_audit:
        assert rep.pool_audit["ok"] and rep.pool_audit["allocated"] == 0
    return {r.rid: tuple(r.generated) for r in rep.requests}, rep


PAGED = dict(paged=True, block_size=4)
# case -> (requests, policy kwargs, baseline kwargs, check on the report)
CASES = {
    "overlap==sequential": (_mix, dict(max_prefill_tokens=6, overlap=True),
                            dict(max_prefill_tokens=6), None),
    "paged==contiguous": (_mix, dict(PAGED, max_prefill_tokens=6,
                                     overlap=True), dict(), None),
    "chunked==unchunked": (_mix, dict(max_prefill_tokens=4), dict(), None),
    "reuse==no_reuse": (
        lambda v: _mix(v, prefix_groups=[14]),
        dict(PAGED, prefix_reuse=True, overlap=True), dict(PAGED),
        lambda rep: rep.prefix_hits >= 1 and rep.reused_blocks >= 3),
    "preempted==unpressured": (
        _preempt_mix, dict(PAGED, max_len=24, num_blocks=6, overlap=True),
        dict(PAGED, max_len=24),
        lambda rep: rep.preemptions >= 1 and rep.truncated == 0),
}


@pytest.fixture(scope="module")
def served(pair, conv):
    """model name -> (model, params): the 4-layer model as it stands and
    its port-converted S3A3E8 form, kernel routes on (their plain versions
    run on CPU tensors)."""
    return {"unconverted": (pair["mt"], pair["pt"]),
            "converted": conv["t"][:2]}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("which", ["unconverted", "converted"])
def test_engine_parity(served, which, case):
    """Identical streams, zero dropped pairs and a clean pool audit
    (checked in _run) on every step kind: prefill chunks, decode, fused
    mixed steps with padded rows masked."""
    model, params = served[which]
    make, kw, base_kw, check = CASES[case]
    reqs = make(model.cfg.vocab_size)
    base, _ = _run(model, params, reqs, **base_kw)
    got, rep = _run(model, params, reqs, **kw)
    assert got == base
    if check is not None:
        assert check(rep), rep.summary()


@pytest.mark.parametrize("which", ["unconverted", "converted"])
def test_engine_matches_static_greedy_loop(served, which):
    """Staggered requests through 2 recycled slots, overlapped, reproduce
    each prompt's static prefill + decode loop token for token."""
    model, params = served[which]
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, model.cfg.vocab_size,
                                               6 + 2 * i).tolist(),
                    max_new=4, arrival=float(i)) for i in range(3)]
    got, rep = _run(model, params, reqs, max_slots=2, max_len=24,
                    overlap=True)
    assert rep.slot_reuse >= 1
    for r in reqs:
        logits, cache = model.prefill(
            params, {"tokens": torch.tensor([r.prompt])}, max_len=24)
        toks = [int(torch.argmax(logits, -1))]
        for i in range(r.max_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[toks[-1]]]), cache,
                len(r.prompt) + i)
            toks.append(int(torch.argmax(logits, -1)))
        assert got[r.rid] == tuple(toks)


def test_mixed_tiers_match_requests_run_alone(served):
    """Sub-level tiers (k' = 1 and 2 beside the default K_max = 3)
    co-batched in overlapped paged steps on the converted model: each
    request gets the stream it gets served alone."""
    model, params = served["converted"]
    reqs = make_requests(4, model.cfg.vocab_size, prompt_range=(6, 10),
                         gen_range=(3, 5), rate=0.0, seed=3,
                         tiers=[1, None, 2])
    got, rep = _run(model, params, reqs, **PAGED, overlap=True)
    assert rep.active_pairs < rep.padded_pairs
    for r in reqs:
        alone, _ = _run(model, params, [dataclasses.replace(r)])
        assert got[r.rid] == alone[r.rid]


# ---------------------------------------------------------------- the CLI

@pytest.mark.parametrize("argv", [
    [], ["--cmoe", "S3A3E8"],
    ["--continuous", "--paged", "--parity", "--requests", "5", "--gen", "4",
     "--prompt-len", "12", "--max-prefill-tokens", "8", "--block-size",
     "8"]], ids=["static", "static_cmoe", "continuous"])
def test_cli_serves_llama4(argv):
    """The CLI at the smoke widths, 4 layers: static as it stands and
    converted, and the engine (converted at the --smoke --continuous
    default S2A2E8) with its parity replays."""
    res = tserve.run(["--smoke", "--arch", ARCH, "--device", "cpu",
                      "--layers", str(LAYERS), "--batch", "2", "--gen", "3",
                      "--use-kernel"] + argv)
    if "--continuous" in argv:
        model = res["engine"].model
        assert res["parity"] == ["overlap == sequential",
                                 "paged == contiguous"]
        assert res["report"].dropped_pairs == 0
        assert res["report"].pool_audit["ok"]
        assert model.cfg.cmoe == CMoEConfig(num_experts=8, num_shared=2,
                                            top_k=2)
        return
    toks = np.asarray(res["tokens"])
    assert toks.shape == (2, 3) and toks.min() >= 0 and toks.max() < 256
    assert torch.isfinite(res["prefill_logits"]).all()
    assert res["backends"] == {"prefill": "grouped_kernel",
                               "decode": "gather"}
    assert ("cmoe" in res["params"]["blocks_moe"]) == bool(argv)
    assert "cmoe" not in res["params"]["blocks_dense"]
