"""The port's continuous-batching engine on the CPU, at the smoke config in
float32.

Parity gates of the port alone: each case serves one request set under a
policy and under its baseline and asserts identical streams (overlapped ==
sequential, paged == contiguous, chunked == unchunked, prefix reuse on ==
off, preemption-pressured == unpressured, mixed tiers == each request run
alone, keyed sampling at temperature > 0 schedule-invariant), zero dropped
pairs and a clean pool audit. Then truncation, pool exhaustion, the CLI,
and one run against the JAX engine on the same weights and requests; then
the same gates on deepseek-v2 (MLA + MoE), as it stands and converted
hierarchically.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE, override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core import convert as jconv
from repro.core import experts as jex
from repro.models import build_model as jbuild
from repro.serving import ServingEngine as JEngine
from repro.serving import make_requests as j_make_requests
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import convert_dense_model
from repro_torch.core.hierarchical import convert_moe_model
from repro_torch.data import make_calibration_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.model import tree_map
from repro_torch.serving import Request, ServingEngine, make_requests

CM = dict(num_experts=8, num_shared=3, top_k=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's steps are many tiny ops: one intra-op thread runs them
    fastest and keeps this file cheap beside the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def served():
    """A converted S3A3E8 smoke model on the CPU, kernel routes on (their
    plain versions run on CPU tensors)."""
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    model = build_model(cfg, use_kernel=True, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init(g)
    calib = make_calibration_batch(cfg.vocab_size, 4, 64, seed=0)
    calib = {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long)}
    model, params, _ = convert_dense_model(model, params, calib,
                                           CMoEConfig(**CM))
    return model, params


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


def _mix(vocab, seed=1, **kw):
    return make_requests(6, vocab, prompt_range=(6, 14), gen_range=(3, 6),
                         rate=0.5, seed=seed, **kw)


def _preempt_mix(vocab, seed=13):
    """A long low-priority request admitted first and a high-priority one
    arriving once it runs, into a pool only one of them fits."""
    rng = np.random.default_rng(seed)
    lo = Request(rid=0, prompt=rng.integers(0, vocab, 8).tolist(),
                 max_new=12, priority=0)
    hi = Request(rid=1, prompt=rng.integers(0, vocab, 8).tolist(),
                 max_new=8, priority=1, arrival=4.0)
    return [lo, hi]


# case -> (requests, policy kwargs, baseline kwargs, check on the report)
PAGED = dict(paged=True, block_size=4)
CASES = {
    "overlap==sequential": (
        _mix, dict(max_prefill_tokens=6, overlap=True),
        dict(max_prefill_tokens=6), None),
    "paged==contiguous": (
        _mix, dict(PAGED, max_prefill_tokens=6, overlap=True), dict(),
        None),
    "chunked==unchunked": (
        _mix, dict(max_prefill_tokens=4), dict(), None),
    "reuse==no_reuse": (
        lambda v: _mix(v, seed=2, prefix_groups=[14]),
        dict(PAGED, prefix_reuse=True, overlap=True), dict(PAGED),
        lambda rep: rep.prefix_hits >= 1 and rep.reused_blocks >= 3 and
        rep.cow_copies >= 1),
    "preempted==unpressured": (
        _preempt_mix, dict(PAGED, max_len=24, num_blocks=6, overlap=True),
        dict(PAGED, max_len=24),
        lambda rep: rep.preemptions >= 1 and rep.truncated == 0),
    "keyed_sampling": (
        _mix, dict(PAGED, max_prefill_tokens=4, overlap=True,
                   temperature=0.8),
        dict(temperature=0.8), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_parity(served, case):
    model, params = served
    make, kw, base_kw, check = CASES[case]
    reqs = make(model.cfg.vocab_size)
    base, _ = _run(model, params, reqs, **base_kw)
    got, rep = _run(model, params, reqs, **kw)
    assert got == base
    if check is not None:
        assert check(rep), rep.summary()


def test_keyed_sampling_draws_vary(served):
    """Temperature > 0 really samples: streams differ from greedy, and two
    seeds give two streams."""
    model, params = served
    reqs = _mix(model.cfg.vocab_size)
    greedy, _ = _run(model, params, reqs)
    hot, _ = _run(model, params, reqs, temperature=0.8, seed=0)
    hot2, _ = _run(model, params, reqs, temperature=0.8, seed=1)
    assert hot != greedy and hot != hot2


def test_mixed_tiers_match_requests_run_alone(served):
    """Mixed activation tiers co-batched in overlapped paged steps give
    each request the stream it gets when served alone at its tier."""
    model, params = served
    reqs = make_requests(4, model.cfg.vocab_size, prompt_range=(6, 10),
                         gen_range=(3, 5), rate=0.0, seed=3,
                         tiers=[1, None])
    got, rep = _run(model, params, reqs, **PAGED, overlap=True)
    assert rep.active_pairs < rep.padded_pairs
    for r in reqs:
        alone, _ = _run(model, params, [dataclasses.replace(r)])
        assert got[r.rid] == alone[r.rid]


def test_truncation_is_surfaced(served):
    """prompt + max_new past max_len is served and clipped at the wall,
    with Request.truncated set and counted, never a silent finish."""
    model, params = served
    reqs = [Request(rid=0, prompt=list(range(1, 11)), max_new=8),
            Request(rid=1, prompt=list(range(3, 7)), max_new=3)]
    for overlap in (False, True):
        got, rep = _run(model, params, reqs, max_len=14, overlap=overlap)
        assert rep.truncated == 1
        assert [r.truncated for r in rep.requests] == [True, False]
        assert len(got[0]) == 14 - 10 + 1 and len(got[1]) == 3


def test_pool_exhaustion_defers_not_drops(served):
    """A pool that fits one request at a time defers admissions (counted
    per cause) and still serves every request the unpressured streams."""
    model, params = served
    rng = np.random.default_rng(15)
    reqs = [Request(rid=i, prompt=rng.integers(0, model.cfg.vocab_size,
                                               8).tolist(),
                    max_new=6, arrival=float(i)) for i in range(3)]
    base, _ = _run(model, params, reqs, **PAGED, max_len=16)
    got, rep = _run(model, params, reqs, **PAGED, max_len=16, num_blocks=4)
    assert got == base
    assert rep.pool_deferrals > 0
    assert rep.deferral_causes == {"pool": rep.gate_deferrals}


@pytest.mark.parametrize("extra", [[], ["--use-kernel"]])
def test_cli_continuous_paged_parity(extra):
    res = tserve.run(["--smoke", "--continuous", "--paged", "--parity",
                      "--device", "cpu", "--requests", "6", "--gen", "6",
                      "--prompt-len", "16", "--max-prefill-tokens", "8",
                      "--block-size", "8"] + extra)
    assert res["parity"] == ["overlap == sequential", "paged == contiguous"]
    assert res["report"].pool_audit["ok"]


@pytest.mark.parametrize("argv,err", [
    (["--smoke", "--continuous", "--device", "cpu",
      "--capacity-factor", "0.75"], "not ported yet"),
    (["--smoke", "--continuous"], "no CUDA device")])
def test_cli_refuses(argv, err):
    """--capacity-factor is the sharded policy (not ported); without
    --device the engine asks for the card, which the CPU has not."""
    if "--device" not in argv and torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises((NotImplementedError, RuntimeError), match=err):
        tserve.run(argv)


def test_engine_matches_jax(monkeypatch):
    """The same converted weights (JAX conversion, carried through the
    bridge) and the same make_requests set, served paged + overlapped at
    S3A3E8 greedy by both engines: every stream is identical."""
    monkeypatch.setenv("REPRO_DECODE_BENCH", "")
    jex._reset_measured_crossover()
    try:
        cfg_j = joverride(j_smoke("qwen1.5-0.5b"), dtype="float32")
        mj = jbuild(cfg_j)
        pj = mj.init(jax.random.PRNGKey(2))
        calib = make_calibration_batch(cfg_j.vocab_size, 4, 64, seed=2)
        mj, pj, _ = jconv.convert_dense_model(
            mj, pj, {"tokens": jax.numpy.asarray(calib["tokens"])},
            JCMoE(**CM))
        kw = dict(max_slots=3, max_len=24, max_prefill_tokens=6,
                  paged=True, block_size=4, overlap=True)
        reqs_j = j_make_requests(5, cfg_j.vocab_size, prompt_range=(6, 14),
                                 gen_range=(3, 6), rate=0.5, seed=4)
        engine_j = JEngine(mj, pj, **kw)
        rep_j = engine_j.run(reqs_j)
        rep_j_log = list(engine_j.backend_log)
    finally:
        jex._reset_measured_crossover()
    cfg_t = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32",
                     cmoe=CMoEConfig(**dataclasses.asdict(mj.cfg.cmoe)))
    mt = build_model(cfg_t, use_kernel=True, device="cpu")
    pt = params_from_jax_numpy(jax.device_get(pj), "cpu")
    reqs_t = make_requests(5, cfg_t.vocab_size, prompt_range=(6, 14),
                           gen_range=(3, 6), rate=0.5, seed=4)
    engine_t = ServingEngine(mt, pt, **kw)
    rep_t = engine_t.run(reqs_t)
    got = {r.rid: tuple(r.generated) for r in rep_t.requests}
    want = {r.rid: tuple(r.generated) for r in rep_j.requests}
    assert got == want
    # the same schedule: every fused step at the same width and live rows,
    # on the same backend policy choice (the port's kernel route stands
    # where the JAX engine ran its XLA grouped path)
    names = {"grouped_xla": "grouped_kernel"}
    assert [row[:4] + (names.get(row[4], row[4]),) for row in
            rep_j_log] == [row[:5] for row in engine_t.backend_log]
    assert rep_t.dropped_pairs == 0 and rep_t.pool_audit["ok"]



# ------------------------------------------- deepseek-v2 (MLA + MoE) engine

@pytest.fixture(scope="module")
def deepseek():
    """The deepseek-v2 smoke model (MLA, 8 experts top-2 with 2 shared) on
    the CPU from a seeded torch init, kernel routes on (their plain
    versions run on CPU tensors)."""
    cfg = override(get_smoke_config("deepseek-v2-236b"), dtype="float32")
    model = build_model(cfg, use_kernel=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return model, params


DS_CASES = {
    "overlap==sequential": (dict(max_prefill_tokens=6, overlap=True),
                            dict(max_prefill_tokens=6)),
    "paged==contiguous": (dict(PAGED, max_prefill_tokens=6, overlap=True),
                          dict()),
    "chunked==unchunked": (dict(max_prefill_tokens=4), dict()),
    "reuse==no_reuse": (dict(PAGED, prefix_reuse=True, overlap=True),
                        dict(PAGED)),
}


@pytest.mark.parametrize("case", list(DS_CASES))
def test_deepseek_engine_parity(deepseek, case):
    """The engine's parity gates on the latent cache: identical streams,
    zero dropped pairs and a clean pool audit (checked in _run)."""
    model, params = deepseek
    kw, base_kw = DS_CASES[case]
    reqs = _mix(model.cfg.vocab_size, seed=2,
                prefix_groups=[14] if case == "reuse==no_reuse" else None)
    base, _ = _run(model, params, reqs, **base_kw)
    got, rep = _run(model, params, reqs, **kw)
    assert got == base
    if case == "reuse==no_reuse":
        assert rep.prefix_hits >= 1 and rep.reused_blocks >= 3


def test_deepseek_engine_matches_static_greedy_loop(deepseek):
    """Staggered requests through 2 recycled slots reproduce, token for
    token, each prompt's static loop: one prefill at a scalar position
    (the flash-style latent prefill) and absorbed decode steps."""
    model, params = deepseek
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, model.cfg.vocab_size,
                                               6 + 2 * i).tolist(),
                    max_new=4, arrival=float(i)) for i in range(3)]
    got, rep = _run(model, params, reqs, max_slots=2, max_len=24)
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


def test_deepseek_cli_static_and_engine(deepseek):
    """Both entry points of the CLI on the deepseek-v2 smoke config: the
    static path on its MoE backends, and the CLI's engine mode
    (serve_continuous: paged, overlapped, with its parity replays) on the
    smoke model built here, since the CLI's --smoke --continuous default
    asks for a conversion."""
    res = tserve.run(["--smoke", "--arch", "deepseek-v2-236b", "--device",
                      "cpu", "--batch", "2", "--gen", "3"])
    assert np.asarray(res["tokens"]).shape == (2, 3)
    assert res["backends"] == {"prefill": "grouped_plain",
                               "decode": "gather"}
    model, params = deepseek
    args = tserve.parser().parse_args(
        ["--continuous", "--paged", "--parity", "--requests", "5", "--gen",
         "4", "--prompt-len", "12", "--max-prefill-tokens", "8",
         "--block-size", "8"])
    res = tserve.serve_continuous(model, params, args)
    assert res["parity"] == ["overlap == sequential", "paged == contiguous"]
    assert res["report"].dropped_pairs == 0
    assert res["report"].pool_audit["ok"]


# ---------------------- hierarchical CMoE of deepseek-v2 (converted MoE)

@pytest.fixture(scope="module")
def hier(deepseek):
    """The deepseek-v2 smoke model converted hierarchically at the CLI's
    smoke default S2A2E8 on its 4 x 128 calibration batch, kernel routes
    on (their plain versions run on CPU tensors)."""
    model, params = deepseek
    calib = make_calibration_batch(model.cfg.vocab_size, 4, 128, seed=0)
    model, params, _ = convert_moe_model(
        model, tree_map(torch.clone, params),
        {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long)},
        CMoEConfig(num_experts=8, num_shared=2, top_k=2))
    return model, params


@pytest.mark.parametrize("case", list(DS_CASES))
def test_hierarchical_engine_parity(hier, case):
    """The engine's parity gates on the converted model (every step kind:
    prefill chunks, decode, fused mixed steps, with padded rows masked):
    identical streams, zero dropped pairs and a clean pool audit (checked
    in _run)."""
    model, params = hier
    kw, base_kw = DS_CASES[case]
    reqs = _mix(model.cfg.vocab_size, seed=2,
                prefix_groups=[14] if case == "reuse==no_reuse" else None)
    base, _ = _run(model, params, reqs, **base_kw)
    got, rep = _run(model, params, reqs, **kw)
    assert got == base
    if case == "reuse==no_reuse":
        assert rep.prefix_hits >= 1 and rep.reused_blocks >= 3


def test_hierarchical_mixed_tiers_match_requests_run_alone(hier):
    """Sub-level tiers (k' = 1 beside the default K_max = 2) co-batched in
    overlapped paged steps: each request gets its stream served alone."""
    model, params = hier
    reqs = make_requests(4, model.cfg.vocab_size, prompt_range=(6, 10),
                         gen_range=(3, 5), rate=0.0, seed=3,
                         tiers=[1, None])
    got, rep = _run(model, params, reqs, **PAGED, overlap=True)
    assert rep.active_pairs < rep.padded_pairs
    for r in reqs:
        alone, _ = _run(model, params, [dataclasses.replace(r)])
        assert got[r.rid] == alone[r.rid]


def test_hierarchical_engine_matches_static_greedy_loop(hier):
    """Staggered requests through 2 recycled slots on the converted model
    reproduce each prompt's static prefill + decode loop token for
    token."""
    model, params = hier
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


@pytest.mark.parametrize("argv", [
    ["--cmoe", "S2A2E8", "--batch", "2", "--gen", "3"],
    ["--continuous", "--paged", "--parity", "--requests", "5", "--gen", "4",
     "--prompt-len", "12", "--max-prefill-tokens", "8", "--block-size",
     "8"]], ids=["static", "continuous"])
def test_cli_converts_deepseek_hierarchically(argv):
    """--cmoe on deepseek-v2 converts it hierarchically, and so does the
    --smoke --continuous default (S2A2E8): the served model is the
    converted one, on the hierarchical backend policy."""
    res = tserve.run(["--smoke", "--arch", "deepseek-v2-236b", "--device",
                      "cpu"] + argv)
    assert res["convert_s"] > 0
    if "--continuous" in argv:
        model = res["engine"].model
        assert res["parity"] == ["overlap == sequential",
                                 "paged == contiguous"]
        assert res["report"].dropped_pairs == 0
        assert res["report"].pool_audit["ok"]
    else:
        model = res["model"]
        assert np.asarray(res["tokens"]).shape == (2, 3)
        assert res["backends"] == {"prefill": "grouped_plain",
                                   "decode": "gather"}
        assert "cmoe" in res["params"]["blocks"]
    assert model.cfg.cmoe == CMoEConfig(num_experts=8, num_shared=2,
                                        top_k=2)


@pytest.mark.parametrize("argv,match", [
    ([], "'frames'"), (["--continuous"], "not slot-addressable"),
    (["--cmoe", "S2A2E8"], "'frames'")], ids=["static", "continuous", "cmoe"])
def test_unported_archs_still_raise(argv, match):
    """whisper-small (enc-dec) runs through the model's entry points only,
    as in the reference: the CLI's static path and its conversion refuse
    it (their token-only batches have no frames; the reference's CLI fails
    on them with KeyError: 'frames'), and the engine refuses the family."""
    with pytest.raises(NotImplementedError, match=match):
        tserve.run(["--arch", "whisper-small", "--smoke", "--device",
                    "cpu"] + argv)


@pytest.mark.parametrize("kw", [dict(paged=False),
                                dict(paged=True, block_size=8),
                                dict(paged=True, block_size=8,
                                     prefix_reuse=True)],
                         ids=["contiguous", "paged", "prefix_reuse"])
def test_finished_engine_frees_its_model_without_gc(kw):
    """With the collector off, dropping the last reference to a finished
    engine frees its model: the engine holds no reference cycle (the
    scheduler's admission, prefix-skip and on-admit hooks are weak)."""
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    reqs = _mix(cfg.vocab_size, prefix_groups=[14] if "prefix_reuse" in kw
                else None)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        engine = ServingEngine(model, params, max_slots=3, max_len=40,
                               prefill_bucket=8, **kw)
        rep = engine.run(reqs)
        assert all(r.done for r in rep.requests)
        alive = weakref.ref(model)
        del engine, rep, model, params
        assert alive() is None
    finally:
        if enabled:
            gc.enable()
