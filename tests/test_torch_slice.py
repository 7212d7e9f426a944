"""The port's whole static slice against the JAX reference, and the port's
hygiene.

Slice: the same dense smoke params (JAX init, carried through the bridge)
are converted to CMoE S3A3E8 in both packages, then prefill 2 x 16 tokens
and decode 8 greedy steps. Logits agree within 1e-4 (float32, the same
arithmetic summed in another order), greedy tokens are identical, and both
packages pick the same backend per phase. The seed is one whose balanced
k-means has no last-bit tie between assignments (see test_torch_convert).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CMoEConfig, override
from repro.configs import get_smoke_config
from repro.core import convert as jconv
from repro.core import experts as jex
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import convert as tconv
from repro_torch.core import experts as tex
from repro_torch.data import make_calibration_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild

ROOT = Path(__file__).resolve().parent.parent
SEED = 2
PORT_NAMES = {"grouped_xla": "grouped_plain",
              "grouped_pallas": "grouped_kernel", "gather": "gather"}


@pytest.fixture
def jax_heuristic_policy(monkeypatch):
    """The JAX backend policy without its measured-crossover file (CPU
    numbers at another bank shape) is the ~E/k heuristic the port uses.
    The JAX module caches the file's crossover per process, so the cache
    is dropped on the way in and on the way out."""
    monkeypatch.setenv("REPRO_DECODE_BENCH", "")
    jex._reset_measured_crossover()
    yield
    jex._reset_measured_crossover()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_smoke_slice_converts_and_serves_like_jax(use_kernel,
                                                  jax_heuristic_policy):
    cm = CMoEConfig(num_experts=8, num_shared=3, top_k=3)
    cfg_j = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    cfg_t = override(t_smoke("qwen1.5-0.5b"), dtype="float32")
    mj = jbuild(cfg_j, use_kernel=use_kernel)
    pj = mj.init(jax.random.PRNGKey(SEED))
    mt = tbuild(cfg_t, use_kernel=use_kernel, device="cpu")
    pt = params_from_jax_numpy(jax.device_get(pj), "cpu")
    calib = make_calibration_batch(cfg_j.vocab_size, 4, 128, seed=SEED)
    cmj, cpj, rj = jconv.convert_dense_model(
        mj, pj, {"tokens": jnp.asarray(calib["tokens"])}, cm)
    cmt, cpt, rt = tconv.convert_dense_model(
        mt, pt, {"tokens": torch.from_numpy(calib["tokens"]).long()}, cm)
    for a, b in zip(rj.parts, rt.parts):
        for key in ("shared_idx", "routed_idx", "rep_idx"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))

    b, s, gen = 2, 16, 8
    prompts = np.random.default_rng(SEED).integers(0, cfg_j.vocab_size,
                                                   (b, s))
    prefill_j = jax.jit(lambda p, t: cmj.prefill(p, {"tokens": t},
                                                 max_len=s + gen))
    decode_j = jax.jit(cmj.decode_step)
    lj, cache_j = prefill_j(cpj, jnp.asarray(prompts))
    lt, cache_t = cmt.prefill(cpt, {"tokens": torch.from_numpy(prompts)},
                              max_len=s + gen)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    tok_j = jnp.argmax(lj, -1)
    tok_t = torch.argmax(lt, -1)
    for i in range(gen):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cache_j = decode_j(cpj, tok_j[:, None], cache_j, jnp.int32(s + i))
        lt, cache_t = cmt.decode_step(cpt, tok_t[:, None], cache_t, s + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4)
        tok_j = jnp.argmax(lj, -1)
        tok_t = torch.argmax(lt, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))

    for phase, t in (("prefill", b * s), ("decode", b)):
        want = jex.microbatch_backend(cmj.cfg, t, phase,
                                      use_kernel=use_kernel)
        got = tex.microbatch_backend(cmt.cfg, t, phase,
                                     use_kernel=use_kernel)
        assert got == PORT_NAMES[want]
        assert (got == "gather") == (phase == "decode")


def test_bridge_carries_bf16_params_bit_for_bit():
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="bfloat16")
    pj = jax.device_get(jbuild(cfg).init(jax.random.PRNGKey(0)))
    pt = params_from_jax_numpy(pj, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(pj)
    assert len(leaves) > 10
    for path, leaf in leaves:
        node = pt
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16 and node.shape == leaf.shape
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))


@pytest.mark.parametrize("argv", [
    ["--smoke", "--cmoe", "S3A3E8", "--gen", "4", "--device", "cpu"],
    ["--smoke", "--cmoe", "S2A2E8", "--batch", "2", "--gen", "3",
     "--device", "cpu", "--use-kernel", "--backend", "all",
     "--temperature", "0.7"]])
def test_serve_cli_runs_on_cpu(argv):
    res = tserve.run(argv)
    b = 4 if "--batch" not in argv else 2
    gen = int(argv[argv.index("--gen") + 1])
    assert np.asarray(res["tokens"]).shape == (b, gen)
    assert res["backends"]["decode"] == "gather"
    assert tserve.main(argv) == 0


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = override(t_smoke("qwen1.5-0.5b"), dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuild(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--gen", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuild(cfg, device="cuda")
    assert tbuild(cfg, device="cpu").use_kernel is False


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s*,|\s+as\b)"
    r"|from\s+repro(\.|\s+import\b))", re.MULTILINE)


def test_port_sources_import_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
