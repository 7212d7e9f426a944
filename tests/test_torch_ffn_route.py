"""The routes of the four FFN kernels, each with a tensor-core kernel
(``swiglu_ffn``, ``moe_gmm_ragged``, ``moe_gather``, ``moe_gmm``), on the
CPU: which CUDA kernel a call would run, that every config's widths reach
the tensor cores in bfloat16, and that a CPU tensor takes the plain version
without counting a launch or a route. The kernels themselves are tested on
a GPU in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import moe_gather, moe_gmm, ops, swiglu

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("module", [swiglu, moe_gmm, moe_gather],
                         ids=["swiglu_ffn", "moe_gmm", "moe_gather"])
@pytest.mark.parametrize("dtype,d,m,want", [
    (BF, 1024, 2816, "tensor_core"),     # qwen1.5-0.5b's dense FFN
    (BF, 5120, 1536, "tensor_core"),     # deepseek-v2's experts
    (BF, 1024, 352, "tensor_core"),      # qwen converted to 8 experts
    (BF, 8, 8, "tensor_core"),
    (F32, 1024, 2816, "simt"),           # float32 at any width
    (F32, 96, 200, "simt"),
    (BF, 1024, 100, "simt"),             # m off the 8 grid
    (BF, 100, 352, "simt"),              # d off the 8 grid
    (torch.float16, 1024, 2816, "simt")])
def test_ffn_route(module, dtype, d, m, want):
    assert module.route(dtype, d, m) == want


def test_every_config_width_takes_the_tensor_cores_in_bf16():
    """d_model and every FFN width the configs give (the dense d_ff, its
    CMoE experts at the default S3A3E8 split, the routed and shared
    experts) lie on the 8 grid, so each bfloat16 model call of swiglu_ffn
    or moe_gmm runs the tensor-core kernel."""
    for arch in ARCHS:
        cfg = get_config(arch)
        widths = [cfg.d_ff, cfg.d_ff // 8] if cfg.d_ff else []
        if cfg.moe is not None:
            widths += [cfg.moe.d_expert, cfg.moe.d_shared]
        for m in widths:
            for module in (swiglu, moe_gmm, moe_gather):
                assert module.route(BF, cfg.d_model, m) == "tensor_core", \
                    (arch, m, module.__name__)


@pytest.mark.parametrize("dtype", [F32, BF])
def test_cpu_wrappers_take_the_plain_path_and_count_nothing(dtype):
    rng = np.random.default_rng(23)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * shape[-2] ** -0.5).to(dtype)

    x, wg, wu, wd = rnd(5, 16), rnd(16, 24), rnd(16, 24), rnd(24, 16)
    xb = rnd(3, 4, 16)
    bg, bu, bd = rnd(3, 16, 24), rnd(3, 16, 24), rnd(3, 24, 16)
    xp = rnd(2 * ops.RAGGED_BLOCK_CPU, 16)
    owner = torch.tensor([2, 0], dtype=torch.int32)
    eidx = torch.tensor([0, 2, 3, 1, 1, 3, 2, 0, 0, 1], dtype=torch.int32)
    ops.reset_launches()
    got = ops.swiglu_ffn(x, wg, wu, wd)
    got_e = ops.moe_gmm(xb, bg, bu, bd, activation="geglu")
    got_r = ops.moe_gmm_ragged(xp, owner, bg, bu, bd,
                               block_c=ops.RAGGED_BLOCK_CPU)
    got_g = ops.moe_gather(x, eidx, bg, bu, bd, top_k=2)
    assert torch.equal(got, swiglu.swiglu_ffn_plain(x, wg, wu, wd))
    assert torch.equal(got_e, moe_gmm.moe_gmm_plain(xb, bg, bu, bd, "geglu"))
    assert torch.equal(got_r, moe_gmm.moe_gmm_ragged_plain(
        xp, owner, bg, bu, bd, block_c=ops.RAGGED_BLOCK_CPU))
    assert torch.equal(got_g, moe_gather.moe_gather_plain(
        x, eidx, bg, bu, bd, top_k=2))
    assert not got_g[eidx == 3].any()                  # the sentinel id E
    assert not any(ops.LAUNCHES[n] for n in ops.ROUTES)
    assert all(not c for c in ops.ROUTES.values())


def test_every_ffn_kernel_counts_its_routes():
    """ops.ROUTES holds one route counter per FFN kernel (the module's own,
    which its CUDA wrapper adds to) beside flash_attention's."""
    assert ops.ROUTES["swiglu_ffn"] is swiglu.ROUTE_LAUNCHES
    assert ops.ROUTES["moe_gmm"] is moe_gmm.ROUTE_LAUNCHES
    assert ops.ROUTES["moe_gmm_ragged"] is moe_gmm.RAGGED_ROUTE_LAUNCHES
    assert ops.ROUTES["moe_gather"] is moe_gather.ROUTE_LAUNCHES
    assert moe_gmm.ROUTE_LAUNCHES is not moe_gmm.RAGGED_ROUTE_LAUNCHES
    assert set(ops.ROUTES) <= set(ops.KERNELS)


def test_reset_launches_clears_the_route_counts():
    swiglu.ROUTE_LAUNCHES["tensor_core"] += 1
    moe_gmm.ROUTE_LAUNCHES["simt"] += 1
    moe_gmm.RAGGED_ROUTE_LAUNCHES["tensor_core"] += 1
    moe_gather.ROUTE_LAUNCHES["simt"] += 1
    ops.reset_launches()
    assert all(not c for c in ops.ROUTES.values())


def test_a_forced_tensor_core_path_is_refused_off_its_route():
    """``path`` may ask for the SIMT kernel (to time it beside the other),
    never for the tensor cores on operands routed elsewhere; the check
    comes before any device is touched."""
    from repro_torch.kernels.common import tc_or_simt
    assert tc_or_simt("tensor_core", None) == "tensor_core"
    assert tc_or_simt("tensor_core", "simt") == "simt"
    assert tc_or_simt("simt", "simt") == "simt"
    with pytest.raises(ValueError):
        tc_or_simt("simt", "tensor_core")
