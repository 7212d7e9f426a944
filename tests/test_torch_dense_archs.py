"""Port parity for the last decoder-only archs: phi3-medium-14b (SwiGLU
GQA), gemma3-4b (GEGLU, 5:1 sliding windows, a tied head), granite-34b
(GELU 2-matrix FFN, MQA: one kv head) and internvl2-26b (the VLM family:
dense blocks behind a prefix of patch embeddings).

Each arch's smoke config in float32; the same weights (JAX's, carried
through the bridge) and inputs go through the JAX reference (its plain
path: nothing here reaches a Pallas kernel on the CPU) and through the
port. Logits agree within LOGIT_TOL of max|logit| and greedy tokens are
equal.

The conversions are S2A2E8 on the CLI's 4 x 128 calibration batch (seed 0).
gemma3, granite and internvl2's smoke experts have m 32 / 32 / 16 neurons,
powers of two, so both packages' k-means see the same float32 distances
and give the same partitions; phi3's m 28 can tie (the k-means then follows
the summation order), and this batch and seed have no tie. The port's
conversion writes the converted banks over the original FFN's storage and
partitions the layers on a thread pool; it is held bit for bit to the
serial, copying loop it replaced (``_serial_copying_convert``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE, VisionConfig as JVision
from repro.config import override as joverride
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import convert as jconv
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import CMoEConfig, VisionConfig, override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import convert as tconv
from repro_torch.core.partition import build_cmoe_params, partition_neurons
from repro_torch.core.profiling import profile_hidden
from repro_torch.data import make_calibration_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.layers import ffn_hidden
from repro_torch.models.model import tree_map, tree_stack
from repro_torch.serving import ServingEngine, make_requests

ARCHS = ["phi3-medium-14b", "gemma3-4b", "granite-34b", "internvl2-26b"]
CM = dict(num_experts=8, num_shared=2, top_k=2)
# the same f32 products summed in another order
LOGIT_TOL = 1e-4
B, S, STEPS = 2, 24, 3
PATCHES = 8


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


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=LOGIT_TOL * np.abs(want).max(), rtol=0)


def _tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _build(arch, vision=None, seed=0):
    """The arch's f32 smoke model in both packages (``vision`` (P, d_patch)
    replaces internvl2's), JAX's weights in both."""
    jkw, tkw = {"dtype": "float32"}, {"dtype": "float32"}
    if vision is not None:
        jkw["vision"], tkw["vision"] = JVision(*vision), VisionConfig(*vision)
    mj = jbuild(joverride(j_smoke(arch), **jkw))
    pj = mj.init(jax.random.PRNGKey(seed))
    host = jax.device_get(pj)
    mt = build_model(override(get_smoke_config(arch), **tkw), use_kernel=True,
                     device="cpu")
    return {"arch": arch, "mj": mj, "pj": pj, "host": host, "mt": mt,
            "pt": params_from_jax_numpy(host, "cpu"),
            "prefill": jax.jit(mj.prefill, static_argnames=("max_len",)),
            "decode": jax.jit(mj.decode_step)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _build(request.param)


def _greedy_both(mj, pj, mt, pt, batch_np, steps, prefill_j, decode_j):
    """A prefill of `batch_np` (tokens and any patches) into a cache with
    room for `steps` more tokens, then `steps` greedy decode steps in both
    packages, each fed its own argmax: logits within LOGIT_TOL of
    max|logit| and the same tokens at every step."""
    seq = batch_np["tokens"].shape[1]
    lj, cj = prefill_j(pj, {k: jnp.asarray(v) for k, v in batch_np.items()},
                       max_len=seq + steps)
    lt, ct = mt.prefill(pt, {k: torch.as_tensor(v)
                             for k, v in batch_np.items()},
                        max_len=seq + steps)
    for i in range(steps + 1):
        _close(lt.numpy(), lj)
        tj, tt = np.argmax(np.asarray(lj), -1), torch.argmax(lt, -1)
        assert tt.tolist() == tj.tolist()
        if i == steps:
            break
        lj, cj = decode_j(pj, jnp.asarray(tj)[:, None], cj, jnp.int32(seq + i))
        lt, ct = mt.decode_step(pt, tt[:, None], ct, seq + i)


# ------------------------------------------------------------ the registry

def test_registry_runs_every_decoder_only_arch():
    """Every arch of the JAX registry is in the port's, this file's four
    and whisper-small too: nothing is left unported."""
    for arch in ARCHS:
        assert arch in tconfigs.ARCHS
    assert tconfigs.NOT_PORTED == ()
    for arch in J_ARCHS:
        assert arch in tconfigs.ARCHS
        assert get_config(arch).name == j_config(arch).name


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch, smoke):
    """The copied configs hold the reference's fields, value for value."""
    want = (j_smoke if smoke else j_config)(arch)
    got = (get_smoke_config if smoke else get_config)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------ the models

def test_params_are_the_references_layout(pair):
    own = pair["mt"].init(torch.Generator().manual_seed(0))
    ref = dict(_leaves(pair["host"]))
    got = dict(_leaves(own))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(got[path].shape) == leaf.shape, path


def test_forward_matches_jax(pair):
    tok = _tokens((B, S))
    want = jax.jit(pair["mj"].forward)(pair["pj"],
                                        {"tokens": jnp.asarray(tok)})
    got = pair["mt"].forward(pair["pt"], {"tokens": torch.as_tensor(tok)})
    _close(got.numpy(), want)
    assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()


def test_prefill_and_decode_match_jax(pair):
    _greedy_both(pair["mj"], pair["pj"], pair["mt"], pair["pt"],
                 {"tokens": _tokens((B, S), seed=5)}, STEPS, pair["prefill"],
                 pair["decode"])


# ------------------------------------------------- internvl2's patch prefix

@pytest.mark.parametrize("d_patch", [0, 32])
def test_vlm_patch_prefix_matches_jax(d_patch):
    """internvl2 with 8 patches in place of the first 8 positions, through
    forward and through prefill(extras) + decode; with d_patch 32 the
    patches go through vision_proj, drawn by init in the reference's shape
    and carried by the bridge."""
    m = _build("internvl2-26b", vision=(PATCHES, d_patch))
    d = m["mt"].cfg.d_model
    own = m["mt"].init(torch.Generator().manual_seed(0))
    assert ("vision_proj" in own) == (d_patch > 0) == ("vision_proj"
                                                       in m["host"])
    if d_patch:
        assert tuple(own["vision_proj"].shape) == (d_patch, d)
        np.testing.assert_array_equal(m["pt"]["vision_proj"].numpy(),
                                      m["host"]["vision_proj"])
    rng = np.random.default_rng(7)
    batch = {"tokens": _tokens((B, S), seed=8),
             "patches": rng.standard_normal(
                 (B, PATCHES, d_patch or d)).astype(np.float32)}
    want = jax.jit(m["mj"].forward)(
        m["pj"], {k: jnp.asarray(v) for k, v in batch.items()})
    got = m["mt"].forward(m["pt"], {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    _close(got.numpy(), want)
    text_only = m["mt"].forward(m["pt"], {"tokens": torch.as_tensor(
        batch["tokens"])})
    assert not torch.allclose(text_only[:, -1], got[:, -1])
    _greedy_both(m["mj"], m["pj"], m["mt"], m["pt"], batch, STEPS,
                 m["prefill"], m["decode"])


# ------------------------------------------------------------- conversion

def _calib():
    c = make_calibration_batch(256, 4, 128, seed=0)
    return c["tokens"]


@pytest.fixture(scope="module")
def conv(pair):
    """JAX's S2A2E8 conversion and the port's of the same weights (the
    port's from a clone, which gives up its FFN), with the clone."""
    tok = _calib()
    mj2, pj2, rj = jconv.convert_dense_model(
        pair["mj"], pair["pj"], {"tokens": jnp.asarray(tok)}, JCMoE(**CM))
    given = tree_map(torch.clone, pair["pt"])
    ptrs = {n: w.data_ptr() for n, w in given["blocks"]["ffn"].items()}
    mt2, pt2, rt = tconv.convert_dense_model(
        pair["mt"], given, {"tokens": torch.as_tensor(tok)},
        CMoEConfig(**CM))
    return {"j": (mj2, pj2, rj), "t": (mt2, pt2, rt), "given": given,
            "ptrs": ptrs}


def test_conversion_matches_jax_leaf_for_leaf(conv):
    """Partitions and every leaf of the converted tree exactly JAX's."""
    _, pj2, rj = conv["j"]
    mt2, pt2, rt = conv["t"]
    assert rt.num_layers == rj.num_layers == mt2.cfg.num_layers
    for a, b in zip(rj.parts, rt.parts):
        for key in ("shared_idx", "routed_idx", "rep_idx"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
    host = jax.device_get(pj2)
    n = 0
    for path, leaf in _leaves(host):
        np.testing.assert_array_equal(_at(pt2, path).numpy(),
                                      np.asarray(leaf), err_msg=str(path))
        n += 1
    assert n == sum(1 for _ in _leaves(pt2))
    assert mt2.cfg.cmoe == CMoEConfig(**CM)


def test_converted_model_matches_jax(pair, conv):
    mj2, pj2, _ = conv["j"]
    mt2, pt2, _ = conv["t"]
    _greedy_both(mj2, pj2, mt2, pt2, {"tokens": _tokens((B, S), seed=9)},
                 STEPS, jax.jit(mj2.prefill, static_argnames=("max_len",)),
                 jax.jit(mj2.decode_step))


def _serial_copying_convert(model, params, batch, cm):
    """The conversion as a serial loop that copies: each layer sliced out,
    profiled, partitioned and converted into a new tree, then stacked, the
    taps taken over the calibration `batch` (tokens, and whisper's
    frames). Returns (cmoe leaves stacked over layers, partitions)."""
    cfg = model.cfg
    taps = model.ffn_inputs(params, batch)
    lyr, b, s, d = taps.shape
    x_all = taps.reshape(lyr, b * s, d)
    layers, parts = [], []
    for li in range(lyr):
        ffn_l = tree_map(lambda a: a[li], params["blocks"]["ffn"])
        a, mu = profile_hidden(ffn_hidden(x_all[li], ffn_l, cfg.activation),
                               cm.k_activation)
        part = partition_neurons(a.numpy(), mu.numpy(), cm)
        layers.append(build_cmoe_params(ffn_l, part, cm, cfg.activation))
        parts.append(part)
    return tree_stack(layers), parts


def test_in_place_conversion_is_the_serial_copying_one(pair, conv):
    """The in-place, pooled conversion gives the serial copying loop's
    tree and partitions bit for bit; the caller's FFN leaves are given up
    and the converted banks live in their storage."""
    mt2, pt2, rt = conv["t"]
    cm = CMoEConfig(**CM)
    want, parts = _serial_copying_convert(
        pair["mt"], pair["pt"], {"tokens": torch.as_tensor(_calib())}, cm)
    got = pt2["blocks"]["cmoe"]
    assert sorted(p for p, _ in _leaves(got)) == \
        sorted(p for p, _ in _leaves(want))
    for path, leaf in _leaves(want):
        assert torch.equal(_at(got, path), leaf), path
    for a, b in zip(parts, rt.parts):
        for key in ("shared_idx", "routed_idx", "rep_idx"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
    assert conv["given"]["blocks"]["ffn"] == {}
    assert "ffn" not in pt2["blocks"]
    # each converted bank pair fills the original bank's storage: layer 0's
    # shared neurons start where the original bank did
    assert sorted(got["shared"]) == sorted(conv["ptrs"])
    for n, ptr in conv["ptrs"].items():
        orig = pair["pt"]["blocks"]["ffn"][n]
        sh, rt_bank = got["shared"][n], got["routed"][n]
        assert sh.numel() + rt_bank.numel() == orig.numel()
        assert sh.data_ptr() == ptr
        assert rt_bank.untyped_storage().data_ptr() == ptr
        assert sh.untyped_storage().nbytes() == orig.numel() * \
            orig.element_size()


# ------------------------------------------- granite's non-GLU routed experts

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_glu_gather_rows_are_the_grouped_rows(dtype):
    """A GELU {wi, wd} bank runs the plain products (the kernels are
    GLU-only). The gather backend (decode) gives each token the bits the
    grouped backend (prefill and the overlapped engine's fused steps)
    gives it, alone or in a micro-batch, sentinel assignments included:
    the parity of overlapped and sequential serving rests on it."""
    from types import SimpleNamespace

    from repro_torch.core.experts import routed_experts
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    t, k, e, d, m = 10, 3, 5, 64, 32

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * shape[-2] ** -0.5).to(dt)

    x = torch.from_numpy(rng.standard_normal((t, d)).astype(
        np.float32)).to(dt)
    bank = {"wi": rnd(e, d, m), "wd": rnd(e, m, d)}
    idx = torch.from_numpy(np.argsort(rng.random((t, e)), 1)[:, :k].copy())
    idx[3, 1] = e                                  # a sentinel assignment
    gates = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    gates[3, 1] = 0.0
    cfg = SimpleNamespace(activation="gelu", cmoe=None, moe=None)

    def run(rows, backend):
        return routed_experts(x[rows], bank, gates[rows], idx[rows], cfg,
                              backend=backend)[0]

    every = slice(0, t)
    got = run(every, "gather")
    assert torch.equal(got, run(every, "grouped_plain"))
    for i in (0, 3, t - 1):
        assert torch.equal(run(slice(i, i + 1), "gather"), got[i:i + 1])
        assert torch.equal(run(slice(i, i + 1), "grouped_plain"),
                           got[i:i + 1])


# -------------------------------------------------------------- the engine

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


# case -> (policy kwargs, baseline kwargs)
CASES = {
    "overlap==sequential": (dict(max_prefill_tokens=6, overlap=True),
                            dict(max_prefill_tokens=6)),
    "paged==contiguous": (dict(paged=True, block_size=4,
                               max_prefill_tokens=6, overlap=True), dict()),
}


@pytest.fixture(scope="module")
def served():
    """granite (MQA) and internvl2 (served text-only) as they stand and
    converted by the port to S2A2E8, kernel routes on (their plain
    versions run on CPU tensors)."""
    out = {}
    for arch in ("granite-34b", "internvl2-26b"):
        m = _build(arch)
        cm2, cp2, _ = tconv.convert_dense_model(
            m["mt"], tree_map(torch.clone, m["pt"]),
            {"tokens": torch.as_tensor(_calib())}, CMoEConfig(**CM))
        out[arch, "unconverted"] = (m["mt"], m["pt"])
        out[arch, "converted"] = (cm2, cp2)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("which", ["unconverted", "converted"])
@pytest.mark.parametrize("arch", ["granite-34b", "internvl2-26b"])
def test_engine_parity(served, arch, which, case):
    """Identical streams, zero dropped pairs and a clean pool audit
    (checked in _run)."""
    model, params = served[arch, which]
    kw, base_kw = CASES[case]
    reqs = make_requests(6, model.cfg.vocab_size, prompt_range=(6, 14),
                         gen_range=(3, 6), rate=0.5, seed=2)
    base, _ = _run(model, params, reqs, **base_kw)
    got, _ = _run(model, params, reqs, **kw)
    assert got == base


# ---------------------------------------------------------------- the CLI

@pytest.mark.parametrize("arch", ARCHS)
def test_cli_converts_and_serves(arch):
    """The CLI at the smoke widths on the CPU, converted to S2A2E8, static;
    the tokens are in the vocabulary and the phases take the engine's
    backends."""
    res = tserve.run(["--smoke", "--arch", arch, "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "3",
                      "--cmoe", "S2A2E8", "--use-kernel"])
    toks = np.asarray(res["tokens"])
    assert toks.shape == (2, 3) and toks.min() >= 0 and toks.max() < 256
    assert res["model"].cfg.cmoe == CMoEConfig(**CM)
    assert res["backends"]["decode"] == "gather"
    assert "ffn" not in res["params"]["blocks"]


@pytest.mark.parametrize("arch", ["granite-34b", "internvl2-26b"])
def test_cli_engine_parity(arch):
    """``--continuous --paged --parity`` on the smoke config (converted
    at the --smoke --continuous default S2A2E8): both replays hold."""
    res = tserve.run(["--smoke", "--arch", arch, "--device", "cpu",
                      "--continuous", "--paged", "--parity", "--requests",
                      "4", "--gen", "3", "--prompt-len", "10",
                      "--max-prefill-tokens", "8", "--block-size", "8"])
    assert res["parity"] == ["overlap == sequential", "paged == contiguous"]
    assert res["report"].dropped_pairs == 0
    assert res["report"].pool_audit["ok"]
