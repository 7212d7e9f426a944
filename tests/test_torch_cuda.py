"""The CUDA kernels against their plain PyTorch versions, on a GPU only.

This file imports no JAX (the GPU machine has none), so it runs there with
the JAX-importing conftest switched off:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: |err| <= 1e-4 max|ref| in float32 (the same fp32 products summed
in another order), 2e-2 max|ref| in bfloat16 (h is rounded to bf16 before
the down product in both, but from slightly different fp32 values)."""
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels.moe_gather import moe_gather_plain
from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain
from repro_torch.kernels.swiglu import swiglu_ffn_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_cuda_kernels_match_plain(dtype, act):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def close(got, ref):
        tol = (1e-4 if dt == torch.float32 else 2e-2) * \
            ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol

    # widths that are not multiples of the 64-wide CUDA tiles
    t, d, f, e, m, k = 100, 96, 200, 5, 72, 3
    x = rnd((t, d))
    wg, wu, wd = rnd((d, f), d ** -0.5), rnd((d, f), d ** -0.5), \
        rnd((f, d), f ** -0.5)
    close(tops.swiglu_ffn(x, wg, wu, wd, activation=act),
          swiglu_ffn_plain(x, wg, wu, wd, act))
    bg, bu, bd = rnd((e, d, m), d ** -0.5), rnd((e, d, m), d ** -0.5), \
        rnd((e, m, d), m ** -0.5)
    block = tops.ragged_block_c()
    xp = rnd((3 * block, d))
    own = torch.tensor([4, 0, 2], dtype=torch.int32, device=dev)
    close(tops.moe_gmm_ragged(xp, own, bg, bu, bd, activation=act,
                              block_c=block),
          moe_gmm_ragged_plain(xp, own, bg, bu, bd, act, block))
    ids = torch.randint(0, e, (7 * k,), generator=g, device=dev)
    ids[::4] = e
    got = tops.moe_gather(x[:7], ids, bg, bu, bd, top_k=k, activation=act)
    close(got, moe_gather_plain(x[:7], ids, bg, bu, bd, top_k=k,
                                activation=act))
    assert (got[ids == e] == 0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_reject_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.randn(8, 64, device=dev)
    w = torch.randn(64, 64, device=dev)
    tops.reset_launches()
    tops.swiglu_ffn(x, w, w, w)
    assert tops.LAUNCHES["swiglu_ffn"] == 1
    with pytest.raises(TypeError):
        tops.swiglu_ffn(x, w, w, w.double())
    with pytest.raises(ValueError):
        tops.swiglu_ffn(x, w, w.t(), w)          # not contiguous
    with pytest.raises(ValueError):
        tops.swiglu_ffn(x, w, w, w.cpu())        # another device
    with pytest.raises(ValueError):
        tops.moe_gmm_ragged(torch.randn(96, 64, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            w[None], w[None], w[None], block_c=96)
    assert tops.LAUNCHES["swiglu_ffn"] == 1
