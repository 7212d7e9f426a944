"""Port parity for the training path beyond the per-arch loss: the
converted (CMoE) fine-tune, the hierarchical deepseek-v2, remat, the
kernel guard of ``Model.loss``, ``make_train_step`` against the JAX
package's jitted step, bitwise resume through the checkpoint manager, and
the train and convert CLIs on the CPU (resume, SIGTERM, --from-ckpt).

Tolerances: losses within 1e-5 relative and gradient leaves within 1e-4
of their max|g| (test_torch_train_archs); five train steps' losses and
grad norms within TRAIN_TOL relative and each leaf's update within
UPDATE_TOL of JAX's in L2; remat and resume bitwise.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig as JCMoE
from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core import convert as jconv
from repro.core import experts as jex
from repro.core import hierarchical as jh
from repro.data.loader import ShardedLoader as JLoader
from repro.launch.steps import make_train_step as j_train_step
from repro.models import build_model as jbuild
from repro.models.model import chunked_ce as j_chunked_ce
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_smoke_config
from repro_torch.core import convert as tconv
from repro_torch.data import ShardedLoader, make_calibration_batch
from repro_torch.launch import convert as convert_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import build_model
from repro_torch.models.model import chunked_ce, tree_leaves, tree_map
from repro_torch.optim import adamw_init, apply_balance_update
from test_torch_train_archs import batches, check_loss_and_grads

QWEN = "qwen1.5-0.5b"
DEEPSEEK = "deepseek-v2-236b"
CM = dict(num_experts=8, num_shared=3, top_k=3, assignment="jv")
TRAIN_TOL = 1e-5
UPDATE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jax_heuristic_policy(monkeypatch):
    """JAX's backend policy without its measured-crossover file, the ~E/k
    heuristic the port uses (see test_torch_slice)."""
    monkeypatch.setenv("REPRO_DECODE_BENCH", "")
    jex._reset_measured_crossover()
    yield
    jex._reset_measured_crossover()


def _pair(arch):
    jcfg = joverride(j_smoke(arch), dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = override(get_smoke_config(arch), dtype="float32")
    return jm, jp, cfg


def _port(jcfg_converted, arch, jparams):
    cfg = override(get_smoke_config(arch), dtype="float32",
                   cmoe=CMoEConfig(**dataclasses.asdict(
                       jcfg_converted.cmoe)))
    return (build_model(cfg, use_kernel=False, device="cpu"),
            params_from_jax_numpy(jax.device_get(jparams), "cpu"))


def _calib(vocab):
    c = make_calibration_batch(vocab, 4, 128, seed=0)
    return {"tokens": jnp.asarray(c["tokens"])}


def test_converted_qwen_trains_like_jax(jax_heuristic_policy):
    """JAX's S3A3E8 conversion carried across: the loss and every gradient
    leaf agree; the learnable scaling u gets a non-zero gradient in every
    layer (the reference's test_converted_model_trains), and moe_load is
    (L, N_r)."""
    jm, jp, cfg = _pair(QWEN)
    jm2, jp2, _ = jconv.convert_dense_model(jm, jp, _calib(cfg.vocab_size),
                                            JCMoE(**CM))
    tm2, tp2 = _port(jm2.cfg, QWEN, jp2)
    jb, tb = batches(tm2.cfg, seed=5)
    (_, metrics, grads), _ = check_loss_and_grads(jm2, jp2, tm2, tp2, jb,
                                                  tb)
    u = grads["blocks"]["cmoe"]["u"]
    assert u.shape == (cfg.num_layers, 5) and bool((u != 0).any(-1).all())
    assert tuple(metrics["moe_load"].shape) == (cfg.num_layers, 5)
    new = apply_balance_update(tp2, metrics["moe_load"], gamma=1e-3)
    moved = (new["blocks"]["cmoe"]["bias"] -
             tp2["blocks"]["cmoe"]["bias"]).abs()
    assert bool(((moved - 1e-3).abs() < 1e-9).any())


def test_hierarchical_deepseek_loss_matches_jax(jax_heuristic_policy):
    """deepseek-v2 converted hierarchically (S3A3E8) by JAX and carried
    across: loss, every gradient leaf (the sub-routers, the sub-experts'
    banks, u) and the top-level moe_load (L, E)."""
    jm, jp, cfg = _pair(DEEPSEEK)
    jm2, jp2, _ = jh.convert_moe_model(jm, jp, _calib(cfg.vocab_size),
                                       JCMoE(**CM))
    tm2, tp2 = _port(jm2.cfg, DEEPSEEK, jp2)
    jb, tb = batches(tm2.cfg, seed=6)
    (_, metrics, grads), _ = check_loss_and_grads(jm2, jp2, tm2, tp2, jb,
                                                  tb)
    assert tuple(metrics["moe_load"].shape) == (cfg.num_layers,
                                                cfg.moe.num_experts)
    assert bool((grads["blocks"]["cmoe"]["u"] != 0).any())


@pytest.mark.parametrize("arch", [QWEN, "llama4-maverick-400b-a17b",
                                  "zamba2-1.2b"])
def test_remat_on_equals_off_bitwise(arch):
    """Layer remat (one checkpoint a layer; llama4's interleaved stack, the
    hybrid's layer with its shared block) changes neither the loss nor
    any gradient bit."""
    cfg = override(get_smoke_config(arch), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg, seed=1)
    out = [value_and_grad(lambda q: m.loss(q, tb, remat=r), p)
           for r in (True, False)]
    (l1, _), g1 = out[0]
    (l2, _), g2 = out[1]
    assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [4, 7, 16, 512])
@pytest.mark.parametrize("tied", [True, False])
def test_chunked_ce_matches_jax(chunk, tied):
    """chunked_ce over 16 positions in chunks that divide them, leave a
    ragged last chunk, equal them and exceed them, with a mask that drops
    positions: the mean and its gradients in x and the head within 1e-5
    relative (JAX pads the last chunk; the port slices it)."""
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    head = rng.standard_normal((24, 8) if tied else (8, 24)).astype(
        np.float32)
    targets = rng.integers(0, 24, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    jl, (jgx, jgh) = jax.value_and_grad(
        lambda a, h: j_chunked_ce(a, h, tied, jnp.asarray(targets),
                                  jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1))(x, head)
    tx, th = (torch.tensor(a, requires_grad=True) for a in (x, head))
    tl = chunked_ce(tx, th, tied, torch.as_tensor(targets).long(),
                    torch.as_tensor(mask), chunk=chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in ((tx.grad, jgx), (th.grad, jgh)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_value_and_grad_and_serving_steps():
    """value_and_grad fills a leaf the loss does not reach with zeros (None
    with fill=False); the serving steps (prefill, whose chunked attention
    then goes through the autograd Function, and decode_step) give the
    same logits bit for bit whether autograd records or not."""
    p = {"w": torch.ones(3), "unused": torch.ones(2)}
    (loss, aux), g = value_and_grad(lambda q: ((q["w"] ** 2).sum(), {}), p)
    assert float(loss) == 3.0 and aux == {}
    assert torch.equal(g["w"], torch.full((3,), 2.0))
    assert torch.equal(g["unused"], torch.zeros(2))
    assert value_and_grad(lambda q: ((q["w"] ** 2).sum(), {}), p,
                          fill=False)[1]["unused"] is None
    cfg = override(get_smoke_config(QWEN), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tracked = tree_map(lambda a: a.detach().requires_grad_(
        a.is_floating_point()), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lp, cache = m.prefill(params, {"tokens": tokens}, max_len=9)
        nxt = lp.argmax(-1)[:, None]
        ld, _ = m.decode_step(params, nxt, cache, 8)
    gp, gcache = m.prefill(tracked, {"tokens": tokens}, max_len=9)
    assert gp.requires_grad and torch.equal(gp.detach(), lp)
    gd, _ = m.decode_step(tracked, nxt, gcache, 8)
    assert torch.equal(gd.detach(), ld)


def test_loss_raises_with_kernels_on():
    """Model.loss refuses a model whose kernels are on while autograd
    records (their outputs carry no graph), naming use_kernel; without
    autograd it evaluates, on the plain versions here."""
    cfg = override(get_smoke_config(QWEN), dtype="float32")
    m = build_model(cfg, use_kernel=True, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg)
    with pytest.raises(RuntimeError, match="use_kernel"):
        m.loss(p, tb)
    with torch.no_grad():
        loss, _ = m.loss(p, tb)
    plain = build_model(cfg, use_kernel=False, device="cpu")
    with torch.no_grad():
        assert torch.equal(loss, plain.loss(p, tb)[0])


def test_train_step_matches_jax():
    """Five steps of make_train_step against the JAX package's jitted step
    on one set of weights and the loader's first batch (both loaders give
    it bitwise), taken five times: loss, grad norm and lr each step within
    TRAIN_TOL, the loss falling, and each leaf's five-step update (p5 -
    p0) within UPDATE_TOL of JAX's in L2. Not elementwise: AdamW divides
    each element's step by its own gradient scale, so an element whose
    gradient is near zero turns float32 rounding into a step of up to lr
    in either package (a handful of elements a leaf, <= 1.2% of the leaf's
    largest update on this batch)."""
    jm, jp, cfg = _pair(QWEN)
    tm = build_model(cfg, use_kernel=False, device="cpu")
    tp = p0 = params_from_jax_numpy(jax.device_get(jp), "cpu")
    kw = dict(lr=3e-3, warmup=2, total=5)
    jstep = jax.jit(j_train_step(jm, **kw))
    tstep = make_train_step(tm, **kw)
    jopt, topt = j_adamw_init(jp), adamw_init(tp)
    jl, tl = JLoader(cfg.vocab_size, 2, 16), ShardedLoader(cfg.vocab_size,
                                                           2, 16)
    tok = next(jl)["tokens"]
    np.testing.assert_array_equal(next(tl)["tokens"], tok)
    losses = []
    for _ in range(5):
        jp, jopt, jmet = jstep(jp, jopt, {"tokens": jnp.asarray(tok)})
        tp, topt, tmet = tstep(tp, topt, {"tokens": torch.as_tensor(
            tok).long()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=TRAIN_TOL)
        losses.append(float(tmet["loss"]))
    assert losses[-1] < losses[0]
    host = jax.device_get(jp)
    for (want, got), (_, start) in zip(_leaf_pairs(host, tp),
                                       _leaf_pairs(host, p0)):
        want = np.asarray(want, dtype=np.float64)
        got, start = got.double().numpy(), start.double().numpy()
        assert np.linalg.norm(got - want) <= \
            UPDATE_TOL * np.linalg.norm(want - start)


def _leaf_pairs(jt, tt):
    if isinstance(tt, dict):
        for k in tt:
            yield from _leaf_pairs(jt[k], tt[k])
    else:
        yield jt, tt


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_resume_is_bitwise(arch, tmp_path):
    """Ten straight train steps equal five, an async checkpoint of params,
    optimizer state and loader position, a restore into fresh trees and a
    fresh loader, and five more, bit for bit (deepseek with the balance
    update after each step)."""
    cfg = override(get_smoke_config(arch), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    step = make_train_step(m, lr=1e-3, warmup=2, total=10, remat=True)

    def run(params, opt, loader, n):
        for _ in range(n):
            batch = {"tokens": torch.as_tensor(next(loader)["tokens"]).long()}
            params, opt, met = step(params, opt, batch)
            if "moe_load" in met:
                params = apply_balance_update(params, met["moe_load"])
        return params, opt

    def fresh():
        p = m.init(torch.Generator().manual_seed(0))
        return p, adamw_init(p), ShardedLoader(cfg.vocab_size, 2, 12, seed=3)

    p, o, ld = fresh()
    want_p, want_o = run(p, o, ld, 10)
    p, o, ld = fresh()
    p, o = run(p, o, ld, 5)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, {"params": p, "opt": o}, {"loader": ld.state_dict(),
                                          "step": 5})
    mgr.wait()
    p2, o2, ld2 = fresh()
    state, extra = CheckpointManager(str(tmp_path)).restore(
        {"params": p2, "opt": o2})
    ld2.load_state_dict(extra["loader"])
    assert extra["step"] == 5 and ld2.state.step == 5
    got_p, got_o = run(state["params"], state["opt"], ld2, 5)
    for a, b in zip(tree_leaves((want_p, want_o)),
                    tree_leaves((got_p, got_o))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _restore_params(ckpt_dir, target):
    mgr = CheckpointManager(ckpt_dir)
    return mgr.restore(target)


def test_train_cli_resume(tmp_path, capsys):
    """train.main on the CPU: a 5-step run checkpointing at step 3; a copy
    of its step-3 checkpoint resumed with --resume auto restores step 3
    and the loader position, runs steps 3-4 with a finite loss, and ends
    bit for bit on the straight run's final checkpoint; resuming a
    finished run prints the restored step and exits 0."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    argv = ["--smoke", "--device", "cpu", "--steps", "5", "--batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--log-every", "1"]
    assert train_cli.main(argv + ["--ckpt-dir", a]) == 0
    assert CheckpointManager(a).all_steps() == [3, 5]
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "ckpt_00000003"),
                    os.path.join(b, "ckpt_00000003"))
    capsys.readouterr()
    assert train_cli.main(argv + ["--ckpt-dir", b]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step 3" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in lines] == [3, 4]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    cfg = override(get_smoke_config(QWEN), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    target = {"params": p, "opt": adamw_init(p)}
    sa, ea = _restore_params(a, target)
    sb, eb = _restore_params(b, target)
    assert ea == eb == {"loader": {"step": 5}, "step": 5}
    for x, y in zip(tree_leaves(sa), tree_leaves(sb)):
        assert torch.equal(x, y)
    assert train_cli.main(argv + ["--ckpt-dir", b]) == 0
    assert "restored step 5, nothing left to run" in capsys.readouterr().out


def test_train_cli_sigterm_saves_and_exits(tmp_path, monkeypatch):
    """SIGTERM during step 2 (sent by a loader patched in process) makes
    the CLI save step 3 synchronously, with the loader at 3, and return 0;
    the SIGTERM handler is the original again afterwards."""
    original = signal.getsignal(signal.SIGTERM)

    class Preempting(ShardedLoader):
        def __next__(self):
            if self.state.step == 2:
                if signal.getsignal(signal.SIGTERM) is original:
                    raise AssertionError("the CLI installed no handler")
                os.kill(os.getpid(), signal.SIGTERM)
            return super().__next__()

    monkeypatch.setattr(train_cli, "ShardedLoader", Preempting)
    d = str(tmp_path)
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "50",
                           "--batch", "2", "--seq", "16",
                           "--ckpt-dir", d]) == 0
    assert signal.getsignal(signal.SIGTERM) is original
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [3]
    with open(os.path.join(d, "ckpt_00000003", "manifest.json")) as f:
        assert '"loader": {"step": 3}' in f.read()


def test_convert_cli_matches_in_memory_conversion(tmp_path):
    """convert.main on the CPU saves {"params": ...} with {arch, cmoe,
    smoke}; restored into the converted model's tree (its own init, whose
    dicts are built in another order), every leaf equals the in-memory
    conversion of the same seed bit for bit. --from-ckpt reads a
    {"params": ...} checkpoint of the dense model."""
    out = str(tmp_path / "cmoe")
    assert convert_cli.main(["--smoke", "--device", "cpu", "--out",
                             out]) == 0
    cfg = override(get_smoke_config(QWEN), dtype="float32")
    m = build_model(cfg, use_kernel=False, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    args = convert_cli.parser().parse_args(["--smoke"])
    cm = convert_cli.conversion_config(cfg, args)
    calib = make_calibration_batch(cfg.vocab_size, 8, 128, seed=1234)
    m2, p2, _ = tconv.convert_dense_model(
        m, tree_map(torch.clone, p),
        {"tokens": torch.as_tensor(calib["tokens"]).long()}, cm)
    target = build_model(m2.cfg, use_kernel=False, device="cpu").init()
    state, extra = _restore_params(out, {"params": target})
    assert extra == {"arch": QWEN, "cmoe": "S3A3E8", "smoke": True}
    got = state["params"]
    for want, have in _leaf_pairs(p2, got):
        assert want.dtype == have.dtype and torch.equal(want, have)
    dense = str(tmp_path / "dense")
    CheckpointManager(dense).save(7, {"params": p}, block=True)
    out2 = str(tmp_path / "cmoe2")
    assert convert_cli.main(["--smoke", "--device", "cpu", "--seed", "9",
                             "--from-ckpt", dense, "--out", out2]) == 0
    state2, _ = _restore_params(out2, {"params": target})
    for x, y in zip(tree_leaves(got), tree_leaves(state2["params"])):
        assert torch.equal(x, y)
