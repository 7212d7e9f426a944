"""Port parity for whisper-small, the encoder-decoder (audio) family: an
encoder of dense blocks over precomputed frame embeddings (the conv
frontend is a stub), a decoder whose blocks add cross-attention over the
encoder's output, the {"self", "cross"} cache, and the CMoE conversion of
the decoder's FFNs.

The smoke config in float32; the same weights (JAX's, carried through the
bridge) and the same numpy-seeded tokens and frames go through the JAX
reference (its plain path: whisper's reaches no Pallas kernel) and through
the port. Logits agree within LOGIT_TOL of max|logit| and greedy tokens are
equal. The conversion is S2A2E8 on the CLI's 4 x 128 calibration batch
(seed 0) plus frames; the smoke experts have m 16 neurons, a power of two,
so both packages' k-means see the same float32 distances and give the same
partitions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE
from repro.config import override as joverride
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import convert as jconv
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models.model import count_params as j_count
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import convert as tconv
from repro_torch.data import make_calibration_batch
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.model import count_params, tree_map
from test_torch_dense_archs import _serial_copying_convert

ARCH = "whisper-small"
CM = dict(num_experts=8, num_shared=2, top_k=2)
# the same f32 products summed in another order
LOGIT_TOL = 1e-4
B, S, STEPS = 2, 24, 3
# the smoke encoder's positions, and a shorter clip
FRAMES, SHORT = 64, 40


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
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close(got, want, tol=LOGIT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=tol * np.abs(want).max(), rtol=0)


def _batch(b=B, s=S, f=FRAMES, seed=3, d=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)),
            "frames": rng.standard_normal((b, f, d)).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    """whisper's f32 smoke model in both packages, JAX's weights in both."""
    mj = jbuild(joverride(j_smoke(ARCH), dtype="float32"))
    pj = mj.init(jax.random.PRNGKey(0))
    host = jax.device_get(pj)
    mt = build_model(override(get_smoke_config(ARCH), dtype="float32"),
                     device="cpu")
    return {"mj": mj, "pj": pj, "host": host, "mt": mt,
            "pt": params_from_jax_numpy(host, "cpu"),
            "prefill": jax.jit(mj.prefill, static_argnames=("max_len",)),
            "decode": jax.jit(mj.decode_step)}


# ------------------------------------------------------------ the config

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_is_the_references(smoke):
    want = (j_smoke if smoke else j_config)(ARCH)
    got = (get_smoke_config if smoke else get_config)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfigs.NOT_PORTED == ()
    assert set(J_ARCHS) <= set(tconfigs.ARCHS)


def test_count_params_is_the_references():
    """The full whisper-small: the reference's count, in its test range."""
    n = count_params(get_config(ARCH))
    assert n == j_count(j_config(ARCH))
    assert 0.2e9 < n < 0.45e9


# ------------------------------------------------------------ the params

@pytest.mark.parametrize("converted", [False, True], ids=["dense", "cmoe"])
def test_params_are_the_references_layout(pair, converted):
    """The port's own init draws the reference's tree, leaf for leaf (under
    a CMoE config: init_encdec_block's and the encoder's dense blocks'
    converted layout, as the reference's init_dense_block gives the audio
    family)."""
    cfg_t, mj = pair["mt"].cfg, pair["mj"]
    if converted:
        cfg_t = cfg_t.with_cmoe(CMoEConfig(**CM))
        mj = jbuild(mj.cfg.with_cmoe(JCMoE(**CM)))
    own = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(0))
    ref = dict(_leaves(jax.eval_shape(lambda: mj.init(
        jax.random.PRNGKey(0)))))
    got = dict(_leaves(own))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == getattr(torch, str(leaf.dtype)), path


def test_bridge_carries_the_audio_tree(pair):
    """enc_blocks, enc_pos, enc_norm, blocks.xattn and blocks.norm_x cross
    unchanged."""
    for key in ("enc_blocks", "enc_pos", "enc_norm"):
        assert key in pair["pt"]
    assert {"xattn", "norm_x"} <= set(pair["pt"]["blocks"])
    for path, leaf in _leaves(pair["host"]):
        np.testing.assert_array_equal(_at(pair["pt"], path).numpy(), leaf,
                                      err_msg=str(path))


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x, sc, bi = (rng.standard_normal(s).astype(np.float32) + 0.5
                 for s in ((3, 5, 64), (64,), (64,)))
    jt = getattr(jnp, dtype)
    want = jlayers.layer_norm(jnp.asarray(x, jt), jnp.asarray(sc),
                              jnp.asarray(bi))
    got = tlayers.layer_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                             torch.as_tensor(sc), torch.as_tensor(bi))
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got.float().numpy(), np.asarray(want, np.float32),
           tol=1e-6 if dtype == "float32" else 1e-2)


def _layer(pair, li=1):
    return (jax.tree.map(lambda a: a[li], pair["pj"]["blocks"]),
            tree_map(lambda a: a[li], pair["pt"]["blocks"]))


def test_cross_kv_project_matches_jax(pair):
    pj_l, pt_l = _layer(pair)
    enc = np.random.default_rng(5).standard_normal(
        (B, SHORT, 64)).astype(np.float32)
    want = jblocks.cross_kv_project(jnp.asarray(enc), pj_l["xattn"],
                                    pair["mj"].cfg)
    got = tblocks.cross_kv_project(torch.as_tensor(enc), pt_l["xattn"],
                                   pair["mt"].cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (B, SHORT, 4, 16)
        _close(g.numpy(), w, tol=1e-6)


@pytest.mark.parametrize("s", [S, 1], ids=["chunked", "decode"])
def test_cross_attention_matches_jax(pair, s):
    """The cross branch of gqa_attention: q without RoPE, every frame
    visible (non-causal chunked attention for S > 1, decode attention at
    pos F - 1 for S == 1), no cache."""
    pj_l, pt_l = _layer(pair)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, s, 64)).astype(np.float32)
    enc = rng.standard_normal((B, SHORT, 64)).astype(np.float32)
    kv_j = jblocks.cross_kv_project(jnp.asarray(enc), pj_l["xattn"],
                                    pair["mj"].cfg)
    kv_t = tblocks.cross_kv_project(torch.as_tensor(enc), pt_l["xattn"],
                                    pair["mt"].cfg)
    pos = np.arange(7, 7 + s)
    want, nj = jattn.gqa_attention(jnp.asarray(x), pj_l["xattn"],
                                   pair["mj"].cfg,
                                   positions=jnp.asarray(pos), cross_kv=kv_j)
    got, nt = tattn.gqa_attention(torch.as_tensor(x), pt_l["xattn"],
                                  pair["mt"].cfg,
                                  positions=torch.as_tensor(pos),
                                  cross_kv=kv_t)
    assert nj is None and nt is None
    _close(got.numpy(), want, tol=1e-5)


@pytest.mark.parametrize("f", [FRAMES, SHORT], ids=["full", "short"])
def test_encoder_matches_jax(pair, f):
    frames = _batch(f=f)["frames"]
    want = pair["mj"]._encode(pair["pj"], jnp.asarray(frames))
    got = pair["mt"]._encode(pair["pt"], torch.as_tensor(frames))
    assert tuple(got.shape) == (B, f, 64)
    _close(got.numpy(), want, tol=1e-5)


# ------------------------------------------------------------ the model

def test_forward_matches_jax(pair):
    batch = _batch()
    want = jax.jit(pair["mj"].forward)(pair["pj"], _j(batch))
    got = pair["mt"].forward(pair["pt"], _t(batch))
    _close(got.numpy(), want)
    assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()
    # the frames reach the logits
    other = pair["mt"].forward(pair["pt"], {**_t(batch), "frames": torch.zeros(
        batch["frames"].shape)})
    assert not torch.allclose(other, got)


def test_init_cache_is_the_references(pair):
    want = pair["mj"].init_cache(B, S + STEPS)
    got = pair["mt"].init_cache(B, S + STEPS)
    assert sorted(got) == sorted(want) == ["cross", "self"]
    for path, leaf in _leaves(want):
        assert tuple(_at(got, path).shape) == leaf.shape, path
    assert tuple(got["cross"][0].shape) == (2, B, FRAMES, 4, 16)


def _greedy_both(mj, pj, mt, pt, batch, prefill_j, decode_j, steps=STEPS):
    """A prefill of `batch` into a cache with room for `steps` more tokens,
    then `steps` greedy decode steps in both packages, each fed its own
    argmax: logits within LOGIT_TOL of max|logit| and the same tokens at
    every step. Returns both final caches."""
    seq = batch["tokens"].shape[1]
    lj, cj = prefill_j(pj, _j(batch), max_len=seq + steps)
    lt, ct = mt.prefill(pt, _t(batch), max_len=seq + steps)
    for i in range(steps + 1):
        _close(lt.numpy(), lj)
        tj, tt = np.argmax(np.asarray(lj), -1), torch.argmax(lt, -1)
        assert tt.tolist() == tj.tolist()
        if i == steps:
            return cj, ct
        lj, cj = decode_j(pj, jnp.asarray(tj)[:, None], cj,
                          jnp.int32(seq + i))
        lt, ct = mt.decode_step(pt, tt[:, None], ct, seq + i)


@pytest.mark.parametrize("f", [FRAMES, SHORT], ids=["full", "short"])
def test_prefill_and_decode_match_jax(pair, f):
    """Tokens equal at every step, and both cache parts equal: "cross"
    holds the F frames the batch gave (fewer than num_frames for a short
    clip, which the decode step's pos F - 1 mask then covers exactly)."""
    cj, ct = _greedy_both(pair["mj"], pair["pj"], pair["mt"], pair["pt"],
                          _batch(f=f, seed=5), pair["prefill"],
                          pair["decode"])
    assert tuple(ct["cross"][0].shape) == (2, B, f, 4, 16)
    for path, leaf in _leaves(jax.device_get(cj)):
        got = _at(ct, path)
        assert tuple(got.shape) == leaf.shape, path
        _close(got.numpy(), leaf, tol=1e-5)


def test_decode_from_a_bridged_cache(pair):
    """JAX's {"self", "cross"} cache crosses the bridge unchanged, and the
    port's decode step from it gives JAX's next logits."""
    batch = _batch(seed=8)
    lj, cj = pair["prefill"](pair["pj"], _j(batch), max_len=S + 1)
    ct = params_from_jax_numpy(jax.device_get(cj), "cpu")
    assert isinstance(ct["cross"], tuple) and isinstance(ct["self"], tuple)
    tok = np.argmax(np.asarray(lj), -1)[:, None]
    want, _ = pair["decode"](pair["pj"], jnp.asarray(tok), cj, jnp.int32(S))
    got, _ = pair["mt"].decode_step(pair["pt"], torch.as_tensor(tok), ct, S)
    _close(got.numpy(), want)


def test_entry_points_need_frames_and_step_refuses(pair):
    tok = torch.as_tensor(_batch()["tokens"])
    for call in (lambda: pair["mt"].forward(pair["pt"], {"tokens": tok}),
                 lambda: pair["mt"].prefill(pair["pt"], {"tokens": tok})):
        with pytest.raises(ValueError, match="frames"):
            call()
    cache = pair["mt"].init_cache(B, S)
    with pytest.raises(NotImplementedError, match="step"):
        pair["mt"].step(pair["pt"], tok, cache, 0)


# ------------------------------------------------------------- conversion

def _calib():
    tok = make_calibration_batch(256, 4, 128, seed=0)["tokens"]
    frames = np.random.default_rng(2).standard_normal(
        (4, FRAMES, 64)).astype(np.float32)
    return {"tokens": np.asarray(tok), "frames": frames}


@pytest.fixture(scope="module")
def conv(pair):
    """JAX's S2A2E8 conversion and the port's of the same weights (the
    port's from a clone, which gives up its decoder FFN), with the clone
    and the encoder's leaves before the conversion."""
    calib = _calib()
    mj2, pj2, rj = jconv.convert_dense_model(pair["mj"], pair["pj"],
                                             _j(calib), JCMoE(**CM))
    given = tree_map(torch.clone, pair["pt"])
    enc = tree_map(torch.clone, given["enc_blocks"])
    mt2, pt2, rt = tconv.convert_dense_model(pair["mt"], given, _t(calib),
                                             CMoEConfig(**CM))
    return {"j": (mj2, pj2, rj), "t": (mt2, pt2, rt), "given": given,
            "enc": enc}


def test_conversion_matches_jax_leaf_for_leaf(conv):
    """Partitions and every leaf of the converted tree exactly JAX's."""
    _, pj2, rj = conv["j"]
    mt2, pt2, rt = conv["t"]
    assert rt.num_layers == rj.num_layers == mt2.cfg.num_layers == 2
    assert rt.calib_tokens == rj.calib_tokens == 4 * 128
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
    # non-GLU routed experts and router
    assert sorted(pt2["blocks"]["cmoe"]["routed"]) == ["wd", "wi"]
    assert sorted(pt2["blocks"]["cmoe"]["router"]) == ["wi_r"]


def test_conversion_leaves_the_encoder_untouched(conv):
    """The in-place write goes over the decoder's FFN only: enc_blocks'
    FFN (whose leaves share key names with blocks') is bitwise unchanged,
    the very tensors the caller gave, and still dense."""
    pt2 = conv["t"][1]
    assert "ffn" in pt2["enc_blocks"] and "cmoe" not in pt2["enc_blocks"]
    assert pt2["enc_blocks"] is conv["given"]["enc_blocks"]
    for path, leaf in _leaves(conv["enc"]):
        assert torch.equal(_at(pt2["enc_blocks"], path), leaf), path


def test_converted_model_matches_jax(pair, conv):
    mj2, pj2, _ = conv["j"]
    mt2, pt2, _ = conv["t"]
    batch = _batch(seed=9)
    want = jax.jit(mj2.forward)(pj2, _j(batch))
    got = mt2.forward(pt2, _t(batch))
    _close(got.numpy(), want)
    _greedy_both(mj2, pj2, mt2, pt2, batch,
                 jax.jit(mj2.prefill, static_argnames=("max_len",)),
                 jax.jit(mj2.decode_step))
    rec_j = jconv.reconstruction_error(pair["mj"], pair["pj"], mj2, pj2,
                                       _j(batch))
    rec_t = tconv.reconstruction_error(pair["mt"], pair["pt"], mt2, pt2,
                                       _t(batch))
    assert rec_t == pytest.approx(rec_j, rel=1e-4)


def test_in_place_conversion_is_the_serial_copying_one(pair, conv):
    """The in-place, pooled conversion gives the serial copying loop's
    tree and partitions bit for bit, the decoder's FFN leaves given up."""
    mt2, pt2, rt = conv["t"]
    want, parts = _serial_copying_convert(pair["mt"], pair["pt"],
                                          _t(_calib()), CMoEConfig(**CM))
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
