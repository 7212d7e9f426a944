"""Port parity for the training substrate: AdamW and its cosine schedule,
the aux-loss-free balance update, LoRA adapters, the sharded loader, the
checkpoint manager and the flash-style attention backward.

Each test gives seeded numpy inputs to the JAX package and to the port.
Tolerances: AdamW's params and moments within 1e-6 (float32 math in both,
rounded at the same points); the schedule and the global norm within 1e-6
relative; the balance update, the loader's batches and a checkpoint
roundtrip bitwise; LoRA merges within 1e-6; the attention gradients
within 1e-5 of max|grad| (the same float32 blocks summed in another
order).
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core.router import update_balance_bias as j_update_bias
from repro.data.loader import ShardedLoader as JLoader
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import balance as jbalance
from repro.optim import lora as jlora
from repro_torch.bridge import params_from_jax_numpy, tensor_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import override
from repro_torch.configs import get_smoke_config
from repro_torch.core.router import update_balance_bias
from repro_torch.data import ShardedLoader
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               apply_balance_update, cosine_schedule,
                               global_norm, init_lora, merge_lora)
from repro_torch.optim.lora import DEFAULT_TARGETS

ADAM_TOL = 1e-6
LORA_TOL = 1e-6
ATTN_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    """A JAX or torch leaf as a float64 numpy array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32)).astype(np.float64)


def _pairs(jt, tt):
    """(JAX leaf, port leaf) pairs matched by key (jax.tree.leaves sorts
    dict keys; the port keeps insertion order)."""
    if isinstance(tt, dict):
        for k in tt:
            yield from _pairs(jt[k], tt[k])
    elif tt is not None:
        yield jt, tt


def _tree(rng):
    """A param tree of float32 and bfloat16 leaves, 1-D leaves among them,
    as numpy arrays (bf16 as ml_dtypes arrays)."""
    bf16 = jnp.bfloat16
    return {
        "embed": rng.standard_normal((12, 8)).astype(np.float32),
        "norm": (0.1 * rng.standard_normal(8)).astype(np.float32),
        "blocks": {
            "w": np.asarray(jnp.asarray(rng.standard_normal((3, 8, 6)),
                                        bf16)),
            "b": np.asarray(jnp.asarray(0.1 * rng.standard_normal(6),
                                        bf16)),
            "u": (0.01 * rng.standard_normal(5)).astype(np.float32),
        },
    }


@pytest.mark.parametrize("grad_scale", [0.05, 10.0],
                         ids=["clip_inactive", "clip_active"])
def test_adamw_update_matches_jax(grad_scale):
    """Three AdamW steps on a tree of f32 and bf16 leaves, 1-D leaves
    among them (no weight decay there), with the global-norm clip inactive
    (gnorm < 1) and active (gnorm > 1): params, m, v, the grad norm and the
    step agree within ADAM_TOL."""
    rng = np.random.default_rng(0)
    host = _tree(rng)
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_jax_numpy(host, "cpu")
    jopt = jadamw.adamw_init(jp)
    topt = adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(
                grad_scale * rng.standard_normal(a.shape), a.dtype)), host)
        lr = jadamw.cosine_schedule(jopt.step, 1e-2, 2, 10)
        jp, jopt, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, g), jopt, jp, lr=lr)
        tlr = cosine_schedule(topt.step, 1e-2, 2, 10)
        tp, topt, tm = adamw_update(params_from_jax_numpy(g, "cpu"), topt,
                                    tp, lr=tlr)
        assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAM_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=ADAM_TOL)
    assert int(topt.step) == int(jopt.step) == 3
    assert topt.step.dtype == torch.int32
    for jt, tt in ((jp, tp), (jopt.m, topt.m), (jopt.v, topt.v)):
        for a, b in _pairs(jt, tt):
            assert b.dtype == tensor_from_numpy(np.asarray(a), "cpu").dtype
            np.testing.assert_allclose(_np(b), _np(a), rtol=ADAM_TOL,
                                       atol=ADAM_TOL)


def test_adamw_moment_dtype_and_new_leaves():
    """moment_dtype sets m and v's dtype; the update returns new tensors
    and leaves its inputs as they were."""
    p = {"w": torch.ones(4, 3), "s": torch.zeros(3)}
    opt = adamw_init(p, moment_dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16
               for x in tree_leaves(opt.m) + tree_leaves(opt.v))
    g = {"w": torch.full((4, 3), 0.5), "s": torch.full((3,), -0.5)}
    new, opt2, _ = adamw_update(g, opt, p, lr=0.1)
    assert torch.equal(p["w"], torch.ones(4, 3)) and int(opt.step) == 0
    assert not torch.equal(new["w"], p["w"]) and int(opt2.step) == 1
    assert opt2.m["w"].dtype == torch.bfloat16


def test_cosine_schedule_and_global_norm_match_jax():
    """The schedule at warmup, mid and end (and past the end), and the
    global norm of a mixed-dtype tree."""
    for step in (0, 1, 5, 10, 11, 55, 100, 120):
        j = float(jadamw.cosine_schedule(jnp.int32(step), 3e-4, 10, 100))
        t = float(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                  3e-4, 10, 100))
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-12)
    s = [float(cosine_schedule(i, 1.0, 10, 100)) for i in range(101)]
    assert s[0] == 0.0 and abs(s[10] - 1.0) < 1e-6
    assert s[100] < s[50] < s[11] and s[100] >= 0.099
    host = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(
        float(global_norm(params_from_jax_numpy(host, "cpu"))),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, host))),
        rtol=1e-6)


def test_adamw_converges_on_quadratic():
    """The port of the reference's quadratic: 300 steps at lr 0.05."""
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(300):
        (_, _), g = value_and_grad(
            lambda p: ((p["w"] ** 2).sum(), {}), params)
        params, opt, _ = adamw_update(g, opt, params,
                                      lr=torch.tensor(0.05),
                                      weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_update_balance_bias_matches_jax():
    rng = np.random.default_rng(1)
    bias = (0.01 * rng.standard_normal(6)).astype(np.float32)
    load = rng.dirichlet(np.ones(6)).astype(np.float32)
    load[2] = 1.0 / 6                       # exactly at p*: no move
    want = np.asarray(j_update_bias(jnp.asarray(bias), jnp.asarray(load),
                                    1e-3))
    got = update_balance_bias(torch.as_tensor(bias), torch.as_tensor(load),
                              1e-3).numpy()
    np.testing.assert_array_equal(got, want)


def _balance_tree(kind: str, rng):
    l, n = 3, 5
    bias = (0.01 * rng.standard_normal((l, n))).astype(np.float32)
    other = rng.standard_normal((l, 4)).astype(np.float32)
    if kind == "cmoe":
        return {"embed": other, "blocks": {"cmoe": {"bias": bias,
                                                    "u": other}}}
    if kind == "moe":
        return {"blocks": {"moe": {"balance_bias": bias, "router": other}}}
    return {"blocks_dense": {"w": other},
            "blocks_moe": {"moe": {"balance_bias": bias, "router": other}}}


@pytest.mark.parametrize("kind", ["cmoe", "moe", "interleaved"])
def test_apply_balance_update_matches_jax(kind):
    """On a converted CMoE tree (blocks.cmoe.bias), a pretrained MoE's
    (blocks.moe.balance_bias) and an interleaved stack's (blocks_moe):
    bitwise JAX's; every other leaf is the input's own tensor."""
    rng = np.random.default_rng(2)
    host = _balance_tree(kind, rng)
    load = rng.dirichlet(np.ones(5), size=3).astype(np.float32)
    load[0, 1] = 0.2                        # exactly p*
    want = jbalance.apply_balance_update(jax.tree.map(jnp.asarray, host),
                                         jnp.asarray(load), gamma=1e-3)
    tp = params_from_jax_numpy(host, "cpu")
    got = apply_balance_update(tp, torch.as_tensor(load), gamma=1e-3)
    for a, b in _pairs(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    key = "blocks_moe" if kind == "interleaved" else "blocks"
    sub = "cmoe" if kind == "cmoe" else "moe"
    name = "bias" if kind == "cmoe" else "balance_bias"
    assert not torch.equal(got[key][sub][name], tp[key][sub][name])
    other = "u" if kind == "cmoe" else "router"
    assert got[key][sub][other] is tp[key][sub][other]


@pytest.fixture(scope="module")
def qwen_pair():
    jcfg = joverride(j_smoke("qwen1.5-0.5b"), dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    return jm, jp, m, params_from_jax_numpy(jax.device_get(jp), "cpu")


def _adapted(tree, prefix=()):
    """Paths of the adapted leaves of an adapter tree (dicts with 'a')."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict) and "a" in v:
            out.append(prefix + (k,))
        elif isinstance(v, dict):
            out += _adapted(v, prefix + (k,))
    return out


def _lora_from_jax(tree):
    if tree is None:
        return None
    return {k: _lora_from_jax(v) if isinstance(v, dict) or v is None
            else tensor_from_numpy(np.asarray(v), "cpu")
            for k, v in tree.items()}


def test_lora_targets_match_jax(qwen_pair):
    """init_lora adapts the same leaves as JAX's, with the same shapes: 2-D
    and stacked 3-D targets, None elsewhere (the 4-D stacked attention
    projections and the embedding are not adapted)."""
    _, jp, _, tp = qwen_pair
    jl = jlora.init_lora(jp, jax.random.PRNGKey(0), rank=4)
    tl = init_lora(tp, torch.Generator().manual_seed(0), rank=4)
    jpaths = sorted(_adapted(jax.device_get(jl)))
    assert jpaths == sorted(_adapted(tl)) and jpaths
    for path in jpaths:
        ja, ta = jl, tl
        for k in path:
            ja, ta = ja[k], ta[k]
        for n in ("a", "b"):
            assert tuple(ta[n].shape) == tuple(ja[n].shape)
            assert ta[n].dtype == torch.float32
        assert not ta["b"].any()
    assert tl["embed"] is None and tl["blocks"]["attn"]["wq"] is None
    assert set(DEFAULT_TARGETS) == set(jlora.DEFAULT_TARGETS)


def test_merge_lora_matches_jax(qwen_pair):
    """JAX's adapters (B drawn non-zero) carried across: merged params
    within LORA_TOL, 2-D and 3-D targets."""
    _, jp, _, tp = qwen_pair
    jl = jlora.init_lora(jp, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(4)
    host = jax.device_get(jl)

    def fill_b(t):
        if t is None:
            return None
        if "a" in t:
            return {"a": np.asarray(t["a"]), "b": (0.1 * rng.standard_normal(
                np.shape(t["b"]))).astype(np.float32)}
        return {k: fill_b(v) for k, v in t.items()}

    host = fill_b(host)
    def to_jax(t):
        if t is None or not isinstance(t, dict):
            return None if t is None else jnp.asarray(t)
        return {k: to_jax(v) for k, v in t.items()}

    jmerged = jlora.merge_lora(jp, to_jax(host), alpha=32.0, rank=4)
    tmerged = merge_lora(tp, _lora_from_jax(host), alpha=32.0, rank=4)
    for a, b in _pairs(jmerged, tmerged):
        np.testing.assert_allclose(_np(b), _np(a), rtol=LORA_TOL,
                                   atol=LORA_TOL)


def test_lora_zero_init_identity_and_learnable(qwen_pair):
    """The port of the reference's test: with B = 0 the merge is the base
    params bit for bit, and one gradient step on the adapters alone lowers
    the loss."""
    _, _, m, tp = qwen_pair
    lora = init_lora(tp, torch.Generator().manual_seed(0), rank=2)
    merged = merge_lora(tp, lora, rank=2)
    for a, b in zip(tree_leaves(merged), tree_leaves(tp)):
        assert torch.equal(a, b)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (2, 24)))
    batch = {"tokens": tokens}
    loss0 = float(m.loss(tp, batch)[0])
    (_, _), g = value_and_grad(
        lambda lo: m.loss(merge_lora(tp, lo, rank=2), batch), lora)
    lora2 = tree_map(lambda a, b: a - 0.5 * b, lora, g)
    with torch.no_grad():
        loss1 = float(m.loss(merge_lora(tp, lora2, rank=2), batch)[0])
    assert loss1 < loss0


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2), (11, 4)])
def test_loader_matches_jax(seed, shards):
    """Every shard's batches bitwise the reference's over several steps."""
    for shard in range(shards):
        jl = JLoader(97, 8, 16, num_shards=shards, shard_id=shard,
                     seed=seed)
        tl = ShardedLoader(97, 8, 16, num_shards=shards, shard_id=shard,
                           seed=seed)
        for _ in range(3):
            a, b = next(jl)["tokens"], next(tl)["tokens"]
            assert b.dtype == a.dtype and b.shape == (8 // shards, 17)
            np.testing.assert_array_equal(b, a)


def test_loader_state_resume():
    """A loader restored from state_dict replays the stream exactly."""
    a = ShardedLoader(97, 4, 16, seed=5)
    for _ in range(3):
        next(a)
    state = a.state_dict()
    want = [next(a)["tokens"] for _ in range(2)]
    b = ShardedLoader(97, 4, 16, seed=5)
    b.load_state_dict(state)
    for w in want:
        np.testing.assert_array_equal(next(b)["tokens"], w)


def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g).bfloat16(),
                       "b": torch.randn(4, generator=g),
                       "ids": torch.arange(6, dtype=torch.int64)},
            "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                              m={"w": torch.randn(3, 4, generator=g)},
                              v={"w": torch.rand(3, 4, generator=g)})}


def test_checkpoint_roundtrip_bitwise(tmp_path):
    """bf16, f32 and int leaves (an AdamWState among them) come back bit
    for bit, with their dtypes, into a target on the target's dtype, and
    with the extra state."""
    tree = _ckpt_tree()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, tree, {"loader": {"step": 5}, "step": 5}, block=True)
    target = tree_map(torch.zeros_like, tree)
    got, extra = mgr.restore(target)
    assert extra == {"loader": {"step": 5}, "step": 5}
    assert isinstance(got["opt"], AdamWState)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got["opt"].step) == 7


def test_checkpoint_retention_and_tmp_ignored(tmp_path):
    """keep=2 keeps the newest two; a leftover .tmp dir (a crash
    mid-save) is never restored; a target whose leaves differ raises."""
    tree = _ckpt_tree()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        tree["params"]["b"] = tree["params"]["b"] + 1
        mgr.save(step, tree, {"step": step}, block=True)
    os.makedirs(tmp_path / "ckpt_00000009.tmp")
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, extra = mgr.restore(tree_map(torch.zeros_like, tree))
    assert extra["step"] == 3 and torch.equal(got["params"]["b"],
                                              tree["params"]["b"])
    with pytest.raises(ValueError):
        mgr.restore({"params": {"w": tree["params"]["w"]}})


def test_checkpoint_async_save_then_wait(tmp_path):
    """An async save writes on a background thread; wait() joins it, and
    the saved values are the ones at save time."""
    tree = _ckpt_tree()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    before = tree["params"]["b"].clone()
    mgr.save(4, tree, {"step": 4})
    assert isinstance(mgr._thread, threading.Thread)
    tree["params"]["b"].add_(1.0)             # after the host copy
    mgr.wait()
    assert mgr._thread is None and mgr.latest_step() == 4
    got, _ = mgr.restore(tree_map(torch.zeros_like, tree))
    assert torch.equal(got["params"]["b"], before)


# (B, S, T, H, KH, D, Dv, causal, window, q_offset, chunk_q, chunk_kv)
ATTN_CASES = {
    "causal_ragged": (2, 40, 40, 4, 4, 16, 16, True, 0, 0, 16, 16),
    "non_causal": (2, 24, 37, 4, 4, 16, 16, False, 0, 0, 16, 16),
    "window": (1, 48, 48, 2, 2, 16, 16, True, 8, 0, 16, 16),
    "q_offset": (2, 20, 30, 2, 2, 16, 16, True, 0, 10, 8, 16),
    "gqa": (2, 33, 33, 4, 2, 16, 16, True, 0, 0, 16, 16),
    "gqa_window_offset_dv": (1, 21, 35, 6, 2, 24, 16, True, 12, 14, 8, 16),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_backward_matches_jax(case):
    """Gradients of chunked_attention (q, k, v, through the GQA repeat)
    against jax.grad of the reference's, for sum(out * g) with seeded g;
    S and T not multiples of the chunks in most cases."""
    b, s, t, h, kh, d, dv, causal, window, off, cq, ck = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, dv)).astype(np.float32)
    g = rng.standard_normal((b, s, h, dv)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jattn.chunked_attention(q_, k_, v_, causal=causal,
                                      window=window, q_offset=off,
                                      chunk_q=cq, chunk_kv=ck)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                  q_offset=off, chunk_q=cq, chunk_kv=ck)
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for name, jg, tg in zip("qkv", jgrads, (tq.grad, tk.grad, tv.grad)):
        jg = np.asarray(jg)
        err = np.abs(tg.numpy() - jg).max()
        assert err <= ATTN_TOL * np.abs(jg).max(), (name, err)


def test_flash_forward_values_unchanged_without_grad():
    """The Function's forward is the chunked forward: the same values with
    and without autograd recording, and with bf16 inputs the output
    keeps v's dtype."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 19, 4, 8)),
                               dtype=torch.float32) for _ in range(3))
    with torch.no_grad():
        a = tattn.chunked_attention(q, k, v, chunk_q=8, chunk_kv=8)
    bq = q.clone().requires_grad_()
    b_ = tattn.chunked_attention(bq, k, v, chunk_q=8, chunk_kv=8)
    assert torch.equal(a, b_.detach()) and b_.grad_fn is not None
    o = tattn.chunked_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                chunk_q=8, chunk_kv=8)
    assert o.dtype == torch.bfloat16
