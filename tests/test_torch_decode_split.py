"""The split decode kernels' plans and routes, on the CPU.

The CUDA core (``csrc/decode_split.cuh``) takes a row's keys in chunks of
``common.DECODE_CHUNK`` positions, and its wrappers size the grid and the
merge's workspace from the view alone; ``flash_decode.route`` picks that
core or the SIMT kernel by (dtype, D). mla_paged_decode's tensor-core
route (``csrc/mla_tc.cuh``) does the same with chunks of
``common.MLA_CHUNK``, and ``paged_attention.mla_route`` picks it or the
SIMT kernel by (dtype, r, dr). All of it is pure host logic, checked here;
the kernels themselves run in ``tests/test_torch_cuda.py`` on a GPU.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_decode, ops, paged_attention
from repro_torch.kernels.common import (DECODE_CHUNK, MLA_CHUNK,
                                        decode_chunks, decode_workspace)


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 128, "split"), ("bfloat16", 64, "split"),
    ("bfloat16", 256, "split"), ("bfloat16", 8, "split"),
    ("bfloat16", 100, "simt"), ("bfloat16", 6, "simt"),
    ("float32", 128, "split"), ("float32", 100, "split"),
    ("float32", 4, "split"), ("float32", 6, "simt"),
    ("float32", 255, "simt"), ("bfloat16", 264, "simt")])
def test_flash_decode_route_by_dtype_and_width(dtype, d, want):
    """The split core where a row is whole 16-byte vectors (D x itemsize a
    multiple of 16) up to D 256; the SIMT kernel elsewhere."""
    assert flash_decode.route(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("view,nch", [(1, 1), (80, 1), (256, 1), (257, 2),
                                      (1100, 5), (2064, 9), (4096, 16)])
def test_decode_chunks_follow_the_view_alone(view, nch):
    """Chunks of a fixed 256 positions: the engine's decode view (80) and
    T 256 fit one (no merge); phase 7's T 1100, PAGED_LONG's 129 x 16 and a
    full 4096 cache do not."""
    assert DECODE_CHUNK == 256
    assert decode_chunks(view) == nch


REPO = Path(__file__).resolve().parents[1]
CORE = REPO / "src/repro_torch/kernels/csrc/decode_split.cuh"
MLA_TC = REPO / "src/repro_torch/kernels/csrc/mla_tc.cuh"


@pytest.mark.parametrize("view,nch", [(1, 1), (80, 1), (96, 1), (1024, 1),
                                      (1025, 2), (2064, 3), (4096, 4)])
def test_mla_chunks_follow_the_view_alone(view, nch):
    """mla_paged_decode's tensor-core route cuts a view into chunks of a
    fixed 1024 positions: the engine's decode views (6 blocks of 16) and a
    contiguous lane of 1024 fit one (no merge); MLA_LONG's 129 x 16 does
    not. The count depends on nothing but the view."""
    assert MLA_CHUNK == 1024
    assert decode_chunks(view, MLA_CHUNK) == nch


def test_mla_chunk_and_widths_are_the_tensor_core_headers():
    """The wrapper sizes the merge's workspace by MLA_CHUNK and routes by
    MLA_TC_RANK / MLA_TC_ROPE; the kernel cuts a view by the header's
    kChunk and takes its kRank / kRope: each pair is one constant."""
    text = MLA_TC.read_text()
    for name, want in (("kChunk", MLA_CHUNK),
                       ("kRank", paged_attention.MLA_TC_RANK),
                       ("kRope", paged_attention.MLA_TC_ROPE)):
        found = re.findall(rf"constexpr int {name} = (\d+);", text)
        assert found == [str(want)], name


def test_mla_workspace_is_allocated_only_for_a_merge():
    """Latent-row partials (rows, heads, nch, r) and their (m, l) pairs in
    one float32 buffer where the view spans chunks; none at the engine's
    decode view."""
    cpu = torch.device("cpu")
    assert decode_workspace(4, 128, 512, 96, cpu, chunk=MLA_CHUNK) == \
        (1, None, 0, 0)
    nch, buf, acc, ml = decode_workspace(32, 128, 512, 2064, cpu,
                                         chunk=MLA_CHUNK)
    assert nch == 3
    assert buf.numel() == 32 * 128 * 3 * (512 + 2)
    assert acc == buf.data_ptr() and ml - acc == 4 * 32 * 128 * 3 * 512


@pytest.mark.parametrize("dtype,r,dr,want", [
    ("bfloat16", 512, 64, "tensor_core"), ("float32", 512, 64, "simt"),
    ("bfloat16", 96, 16, "simt"), ("bfloat16", 32, 8, "simt"),
    ("bfloat16", 512, 32, "simt"), ("bfloat16", 256, 64, "simt"),
    ("bfloat16", 1024, 64, "simt"), ("float32", 96, 16, "simt")])
def test_mla_route_by_dtype_and_widths(dtype, r, dr, want):
    """The tensor cores for bfloat16 at deepseek-v2's widths (r 512, dr
    64), whatever the rows, heads or depth; the SIMT kernel for float32
    (phase 5a) and every other width (the smoke configs' r 32)."""
    assert paged_attention.mla_route(getattr(torch, dtype), r, dr) == want


def test_mla_routes_are_counted_and_reset():
    """ops.ROUTES holds mla_paged_decode's route counter, which
    reset_launches clears; a CPU call runs the plain version and counts
    nothing."""
    counts = paged_attention.MLA_ROUTE_LAUNCHES
    assert ops.ROUTES["mla_paged_decode"] is counts
    counts["tensor_core"] += 1
    ops.reset_launches()
    assert not counts
    g = torch.Generator().manual_seed(0)
    qa, qp = torch.randn((2, 3, 16), generator=g), torch.randn((2, 3, 8),
                                                               generator=g)
    cc, cp = torch.randn((5, 4, 16), generator=g), torch.randn((5, 4, 8),
                                                               generator=g)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, -1], dtype=torch.int32)
    out = ops.mla_paged_decode(qa, qp, cc, cp, table=table, pos=pos,
                               scale=0.2)
    assert torch.equal(out, paged_attention.mla_paged_decode_plain(
        qa, qp, cc, cp, table, pos, scale=0.2))
    assert not counts and ops.LAUNCHES["mla_paged_decode"] == 0


def test_decode_chunk_is_the_core_headers():
    """The wrappers size the grid and the merge's workspace by
    DECODE_CHUNK, the kernels cut a view by the header's kChunk: the two
    are one constant."""
    found = re.findall(r"constexpr int kChunk = (\d+);", CORE.read_text())
    assert found == [str(DECODE_CHUNK)]


def test_bench_core_copy_patches_chunk_and_ring(tmp_path):
    """tools/bench_ab.py decode --core times a copy of the checkout whose
    core takes other chunks and rings; the shipped files stay as they
    are."""
    spec = importlib.util.spec_from_file_location(
        "bench_ab", REPO / "tools/bench_ab.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    root = tmp_path / "root"
    for rel in (bench.CORE, bench.COMMON, "chip_smoke.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(REPO / rel, root / rel)
    copy = Path(bench.core_copy(str(root), 128, 4))
    core = (copy / bench.CORE).read_text()
    assert "constexpr int kChunk = 128;" in core
    assert "constexpr int kStages = 4;" in core
    assert "DECODE_CHUNK = 128\n" in (copy / bench.COMMON).read_text()
    assert (root / bench.CORE).read_text() == CORE.read_text()


def test_decode_workspace_is_allocated_only_for_a_merge():
    """One float32 buffer: the partials (rows, heads, nch, hd), then their
    (m, l) pairs; none (NULL pointers) where the view fits one chunk."""
    assert decode_workspace(3, 4, 64, 200, torch.device("cpu")) == \
        (1, None, 0, 0)
    nch, buf, acc, ml = decode_workspace(3, 4, 64, 600, torch.device("cpu"))
    assert nch == 3
    assert buf.dtype == torch.float32 and buf.numel() == 3 * 4 * 3 * 66
    assert acc == buf.data_ptr() and ml - acc == 4 * 3 * 4 * 3 * 64
    with pytest.raises(ValueError):
        decode_chunks(0)


def test_flash_decode_routes_are_counted_and_reset():
    """ops.ROUTES holds flash_decode's route counter, which reset_launches
    clears; a CPU call runs the plain version and counts nothing."""
    assert ops.ROUTES["flash_decode"] is flash_decode.ROUTE_LAUNCHES
    flash_decode.ROUTE_LAUNCHES["split"] += 1
    ops.reset_launches()
    assert not flash_decode.ROUTE_LAUNCHES
    q, k, v = (torch.randn(s) for s in ((2, 1, 8), (2, 5, 8), (2, 5, 8)))
    out = ops.flash_decode(q, k, v, 3)
    assert torch.equal(out, flash_decode.flash_decode_plain(q, k, v, 3))
    assert not flash_decode.ROUTE_LAUNCHES
    assert ops.LAUNCHES["flash_decode"] == 0
