"""The bounded-buffer routed-expert path and the CMoE router's scoring in
the port, against the JAX package on the CPU.

* ``moe_gmm_plain`` against the JAX ``ops.moe_gmm`` (Pallas, interpret
  mode) at the reference test's shapes, with its tolerances (2e-5 in
  float32; 5e-2 in bfloat16, where h is rounded from fp32 sums taken in
  another order);
* ``router_score_plain`` against the JAX ``ops.router_score``, atol = rtol
  = 2e-5, and the CUDA kernel's launch plan (``router_score.plan``), host
  logic held to its constants in ``csrc/router_score.cu``;
* the capacity machinery: ``assign_positions`` exactly equal (with and
  without priority, tied priorities, sentinel ids), ``dispatch`` and
  ``combine`` within 1e-6 in float32, drops and sentinel rows included
  (``combine`` clamps an out-of-range index as JAX's gather does),
  ``grouped_expert_ffn`` on glu and non-glu banks;
* the whole path (moe_gate -> assign_positions -> dispatch -> expert_ffn
  -> combine) on deepseek-v2's smoke config in both packages, within 1e-5
  of max|ref| in float32, and against the port's own drop-free oracle.

Every input is drawn from a seeded numpy generator; weights cross through
``bridge.params_from_jax_numpy``."""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import override as joverride
from repro.configs import get_smoke_config as j_smoke
from repro.core import experts as jex
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.config import override
from repro_torch.configs import get_smoke_config
from repro_torch.core import experts as tex
from repro_torch.kernels import router_score
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.kernels.router_score import router_score_plain
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.model import tree_map

ARCH = "deepseek-v2-236b"


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("e,c,d,m", [(4, 40, 32, 48), (2, 64, 16, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_jax(e, c, d, m, dtype):
    rng = np.random.default_rng(e * 1000 + c)
    arrays = [_rand(rng, (e, c, d)), _rand(rng, (e, d, m), 0.2),
              _rand(rng, (e, d, m), 0.2), _rand(rng, (e, m, d), 0.2)]
    jt = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    exp = jops.moe_gmm(*jt, block_c=16, block_m=16)
    got = moe_gmm_plain(*tt)
    assert got.dtype == tt[0].dtype and got.shape == (e, c, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **_tol(dtype))


@pytest.mark.parametrize("t,d,nr", [(100, 32, 5), (256, 16, 13)])
def test_router_score_plain_matches_jax(t, d, nr):
    rng = np.random.default_rng(t + nr)
    x, wg, wu = _rand(rng, (t, d)), _rand(rng, (d, nr), 0.3), \
        _rand(rng, (d, nr), 0.3)
    exp = jops.router_score(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                            block_t=32)
    got = router_score_plain(*(torch.from_numpy(a) for a in (x, wg, wu)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


ROUTER_CU = Path(__file__).resolve().parents[1] / \
    "src/repro_torch/kernels/csrc/router_score.cu"


@pytest.mark.parametrize("t,d,nr,itemsize", [
    (512, 1024, 5, 2), (512, 1024, 5, 4), (1, 1024, 5, 2), (4, 1024, 5, 2),
    (100, 4096, 5, 2), (128, 4096, 13, 2), (128, 4096, 13, 4),
    (100, 4096, 5, 4), (8, 32, 16, 4), (65536, 4096, 16, 4)])
def test_router_score_plan(t, d, nr, itemsize):
    """router_score's CUDA launch plan, a function of (T, d, N_r, dtype)
    alone: one row a warp at qwen's calibration batch over 128 blocks, the
    weights staged whole where they fit the budget (d 1024 x N_r 5: 20 KB
    in bf16, 40 KB in f32) and in chunks only past it; every row covered
    and no staged chunk over the budget."""
    pl = router_score.plan(t, d, nr, itemsize)
    vec = 16 // itemsize
    w = router_score.ROUTER_WARPS
    assert pl["blocks"] * w * pl["rows_per_warp"] >= t
    assert (pl["blocks"] - 1) * w * pl["rows_per_warp"] < t or \
        pl["blocks"] == router_score.ROUTER_MAX_BLOCKS
    assert pl["chunk"] % vec == 0 and pl["chunks"] * pl["chunk"] >= d
    assert pl["smem"] == pl["chunk"] // vec * 32 * (nr | 1)
    assert pl["smem"] <= router_score.ROUTER_SMEM
    whole = 2 * d * (nr | 1) * itemsize <= router_score.ROUTER_SMEM
    assert (pl["chunks"] == 1) == whole
    if (t, d, nr) == (512, 1024, 5):
        assert pl["blocks"] >= 128 and pl["rows_per_warp"] == 1
        assert pl["smem"] == {2: 20480, 4: 40960}[itemsize]


def test_router_score_plan_rejects_and_matches_the_kernel():
    """d off the 16-byte vectors and N_r past 16 are refused before any
    launch; the plan's constants are the kernel's."""
    with pytest.raises(ValueError):
        router_score.plan(4, 1020, 5, 2)
    with pytest.raises(ValueError):
        router_score.plan(4, 1024, 17, 4)
    text = ROUTER_CU.read_text()
    for name, want in (("kWarps", router_score.ROUTER_WARPS),
                       ("kSmemBudget", router_score.ROUTER_SMEM),
                       ("kMaxCols", router_score.MAX_ROUTER_COLS)):
        found = re.findall(rf"constexpr int {name} = ([\d *]+);", text)
        assert len(found) == 1, name
        assert math.prod(int(f) for f in found[0].split("*")) == want, name


def _assignments(case, rng, t=24, k=3, e=5):
    """(expert ids (t, k) int32, priority (t, k) f32 or None) for a case."""
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    pri = None
    if case == "priority":
        pri = rng.random((t, k)).astype(np.float32)
    elif case == "tied_priority":
        pri = (rng.integers(0, 3, (t, k)) / 2).astype(np.float32)
    elif case == "sentinel":
        idx[rng.random((t, k)) < 0.3] = e
        pri = (rng.integers(0, 2, (t, k)) / 2).astype(np.float32)
    return idx, pri


@pytest.mark.parametrize("case", ["no_priority", "priority", "tied_priority",
                                  "sentinel"])
@pytest.mark.parametrize("capacity", [3, 40])
def test_assign_positions_matches_jax(case, capacity):
    rng = np.random.default_rng(7)
    idx, pri = _assignments(case, rng)
    pos_j, keep_j = jex.assign_positions(
        jnp.asarray(idx), 5, capacity,
        priority=None if pri is None else jnp.asarray(pri))
    pos_t, keep_t = tex.assign_positions(
        torch.from_numpy(idx), 5, capacity,
        priority=None if pri is None else torch.from_numpy(pri))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert keep_t.all() == (capacity == 40)


@pytest.mark.parametrize("case", ["priority", "sentinel"])
def test_dispatch_and_combine_match_jax(case):
    """Tight capacity (drops) with sentinel assignments whose gates are not
    zero: dispatch drops their writes, and combine reads the clamped row
    ybuf[E - 1, p] and weights it by gate x keep, as the reference does."""
    rng = np.random.default_rng(11)
    e, cap, d = 5, 4, 16
    idx, pri = _assignments(case, rng, e=e)
    t, k = idx.shape
    x = _rand(rng, (t, d))
    gates = rng.random((t, k)).astype(np.float32)
    ybuf = _rand(rng, (e, cap, d))
    pos_j, keep_j = jex.assign_positions(jnp.asarray(idx), e, cap,
                                         priority=jnp.asarray(pri))
    info_j = jex.DispatchInfo(jnp.asarray(idx), pos_j, keep_j,
                              jnp.asarray(gates))
    pos_t, keep_t = tex.assign_positions(torch.from_numpy(idx), e, cap,
                                         priority=torch.from_numpy(pri))
    info_t = tex.DispatchInfo(torch.from_numpy(idx), pos_t, keep_t,
                              torch.from_numpy(gates))
    assert not keep_t.all()
    if case == "sentinel":
        assert (keep_t & (torch.from_numpy(idx) == e)).any()
    buf_j = jex.dispatch(jnp.asarray(x), info_j, e, cap)
    buf_t = tex.dispatch(torch.from_numpy(x), info_t, e, cap)
    np.testing.assert_allclose(buf_t.numpy(), np.asarray(buf_j), atol=1e-6,
                               rtol=0)
    out_j = jex.combine(jnp.asarray(ybuf), info_j)
    out_t = tex.combine(torch.from_numpy(ybuf), info_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_grouped_expert_ffn_matches_jax(glu, use_kernel):
    """Glu banks under use_kernel take ops.moe_gmm (its plain version on a
    CPU tensor; interpret-mode Pallas in JAX); a non-glu {wi, wd} bank runs
    the plain products in both packages even under use_kernel."""
    rng = np.random.default_rng(3)
    e, c, d, m = 3, 10, 24, 40
    xbuf = _rand(rng, (e, c, d))
    w = {"wd": _rand(rng, (e, m, d), m ** -0.5)}
    names = ("wg", "wu") if glu else ("wi",)
    for n in names:
        w[n] = _rand(rng, (e, d, m), d ** -0.5)
    act = "swiglu" if glu else "gelu"
    exp = jex.grouped_expert_ffn(jnp.asarray(xbuf),
                                 {k: jnp.asarray(v) for k, v in w.items()},
                                 act, use_kernel=use_kernel)
    got = tex.grouped_expert_ffn(torch.from_numpy(xbuf),
                                 {k: torch.from_numpy(v) for k, v in
                                  w.items()}, act, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


def _path(mod_moe, mod_ex, xf, p, moe, activation, capacity, asarray):
    """The bounded-buffer path of one package: the router's own gates as
    priority, dispatch, expert_ffn with kernels on, combine."""
    gates, idx, _ = mod_moe.moe_gate(xf, p, moe)
    e = moe.num_experts
    pos, keep = mod_ex.assign_positions(idx, e, capacity, priority=gates)
    info = mod_ex.DispatchInfo(idx, pos, keep, gates)
    xbuf = mod_ex.dispatch(xf, info, e, capacity)
    ybuf = mod_moe.expert_ffn(xbuf, asarray(p["wg"]), asarray(p["wu"]),
                              asarray(p["wd"]), activation, use_kernel=True)
    return mod_ex.combine(ybuf, info), gates, idx, pos, keep


@pytest.fixture(scope="module")
def deepseek_ffn_input():
    """deepseek-v2's smoke config in float32 from one set of JAX params:
    each package's captured FFN input of the last layer on 2 x 16 tokens,
    and that layer's MoE params in both."""
    cfg_j = joverride(j_smoke(ARCH), dtype="float32")
    cfg_t = override(get_smoke_config(ARCH), dtype="float32")
    pj = jax.device_get(jax.jit(jbuild(cfg_j).init)(jax.random.PRNGKey(0)))
    pt = params_from_jax_numpy(pj, "cpu")
    tok = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 16))
    li = cfg_t.num_layers - 1
    xj = jbuild(cfg_j).ffn_inputs(pj, {"tokens": jnp.asarray(tok)})[li]
    xt = build_model(cfg_t, device="cpu").ffn_inputs(
        pt, {"tokens": torch.from_numpy(tok)})[li]
    pj_l = jax.tree_util.tree_map(lambda a: a[li], pj["blocks"]["moe"])
    pt_l = tree_map(lambda a: a[li], pt["blocks"]["moe"])
    return cfg_j, cfg_t, np.array(xj), xt, pj_l, pt_l


@pytest.mark.parametrize("roomy", [True, False])
def test_capacity_path_matches_jax_on_deepseek_smoke(deepseek_ffn_input,
                                                     roomy):
    """At C >= the largest expert load nothing drops and the port equals
    its own drop-free routed_experts(backend="exact"); at a tight C the
    dropped pairs equal each expert's load past C, and the output equals
    the exact oracle masked by keep. Both packages agree within 1e-5 of
    max|ref| throughout."""
    cfg_j, cfg_t, xj, xt, pj_l, pt_l = deepseek_ffn_input
    d = cfg_t.d_model
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-5 * np.abs(xj).max(),
                               rtol=0)
    xf_np = xj.reshape(-1, d)
    xf = torch.from_numpy(xf_np)
    moe = cfg_t.moe
    _, idx0, _ = tmoe.moe_gate(xf, pt_l, moe)
    load = torch.bincount(idx0.reshape(-1), minlength=moe.num_experts)
    cap = int(load.max()) if roomy else max(1, int(load.max()) // 3)
    out_j, *_ = _path(jmoe, jex, jnp.asarray(xf_np), pj_l, cfg_j.moe,
                      cfg_j.activation, cap, jnp.asarray)
    out_t, gates, idx, pos, keep = _path(tmoe, tex, xf, pt_l, moe,
                                         cfg_t.activation, cap,
                                         lambda a: a)
    scale = float(np.abs(np.asarray(out_j)).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-5 * scale, rtol=0)
    dropped = int(tex.dropped_pairs(keep, None, idx.shape))
    assert dropped == int((load - cap).clamp(min=0).sum())
    assert (dropped == 0) == roomy
    bank = {n: pt_l[n] for n in ("wg", "wu", "wd")}
    ref, _ = tex.routed_experts(xf, bank, gates, idx, cfg_t,
                                backend="exact",
                                valid=None if roomy else keep)
    np.testing.assert_allclose(out_t.numpy(), ref.numpy(),
                               atol=1e-5 * float(ref.abs().max()), rtol=0)
