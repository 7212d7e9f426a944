"""The split-KV decode core's plan and flash_decode's routes, on the CPU.

The CUDA core (``csrc/decode_split.cuh``) takes a row's keys in chunks of
``common.DECODE_CHUNK`` positions, and its wrappers size the grid and the
merge's workspace from the view alone; ``flash_decode.route`` picks that
core or the SIMT kernel by (dtype, D). Both are pure host logic, checked
here; the kernels themselves run in ``tests/test_torch_cuda.py`` on a GPU.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_decode, ops
from repro_torch.kernels.common import (DECODE_CHUNK, decode_chunks,
                                        decode_workspace)


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
