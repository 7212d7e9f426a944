"""Build and load the port's CUDA kernels.

Each source in ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go into
``kernels/build/`` (listed in ``.gitignore``) under a name that carries a
hash of the sources and flags, so an edited source never loads a stale
library; nvcc's output (ptxas's registers and spills) is kept beside each
as ``.log``. All sources compile in parallel, one ``nvcc`` each, on first use.
Nothing here runs at import time: the CPU tests import this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("swiglu", "moe_gmm", "moe_gather", "paged_attn", "mla_paged",
           "ssd_scan", "router_score", "flash_attention", "flash_decode")
HEADERS = ("ffn_core.cuh", "ffn_tc.cuh", "convert.cuh", "wgmma.cuh",
           "decode_split.cuh", "mla_tc.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points by name: (the source that exports it, its argument types).
# Every pointer and the stream as c_void_p, sizes as c_int, the attention
# scale as c_float, element strides as c_longlong. A source may export more
# than one entry: moe_gmm.cu holds both grouped expert FFNs of the Pallas
# file it ports, over shared cores, so they build in one nvcc process; the
# `_tc_launch` entries are the tensor-core routes of their kernels,
# `flash_decode_split_launch` flash_decode's split-KV route, and the three
# `ssd_` entries the passes of the SSD chunk scan.
SIGNATURES = {
    "swiglu_ffn_launch": ("swiglu", [_P] * 6 + [_I] * 5 + [_P]),
    "swiglu_ffn_tc_launch": ("swiglu", [_P] * 6 + [_I] * 4 + [_P]),
    "moe_gmm_ragged_launch": ("moe_gmm", [_P] * 7 + [_I] * 7 + [_P]),
    "moe_gmm_ragged_tc_launch": ("moe_gmm", [_P] * 7 + [_I] * 5 + [_P]),
    "moe_gmm_launch": ("moe_gmm", [_P] * 6 + [_I] * 6 + [_P]),
    "moe_gmm_tc_launch": ("moe_gmm", [_P] * 6 + [_I] * 5 + [_P]),
    "moe_gather_launch": ("moe_gather", [_P] * 7 + [_I] * 7 + [_P]),
    "moe_gather_tc_launch": ("moe_gather", [_P] * 7 + [_I] * 7 + [_P]),
    "paged_attn_decode_launch": ("paged_attn",
                                 [_P] * 8 + [_I] * 8 + [_F, _I, _P]),
    "mla_paged_decode_launch": ("mla_paged",
                                [_P] * 7 + [_I] * 6 + [_F, _I, _P]),
    "mla_paged_decode_tc_launch": ("mla_paged",
                                   [_P] * 9 + [_I] * 7 + [_F, _P]),
    "ssd_chunk_states_launch": ("ssd_scan", [_P] * 6 + [_I] * 5 + [_L] * 6
                                + [_I] * 2 + [_P]),
    "ssd_state_pass_launch": ("ssd_scan", [_P] * 3 + [_I] * 6 + [_P]),
    "ssd_chunk_out_launch": ("ssd_scan", [_P] * 10 + [_I] * 5 + [_L] * 8
                             + [_I] * 3 + [_P]),
    "router_score_launch": ("router_score", [_P] * 4 + [_I] * 8 + [_P]),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 4 + [_I] * 4 + [_F, _I, _I, _P]),
    "flash_attention_tc_launch": ("flash_attention",
                                  [_P] * 4 + [_I] * 4 + [_F, _I, _P]),
    "flash_decode_launch": ("flash_decode", [_P] * 5 + [_I] * 3 + [_F, _I, _P]),
    "flash_decode_split_launch": ("flash_decode",
                                  [_P] * 7 + [_I] * 4 + [_F, _I, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library is (or will be) built."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds each build took (0 for a library already built).
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in SOURCES}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)        # atomic: a reader never sees half a .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """nvcc/ptxas output of the build of `name`'s current library (kept
    beside it; '' if it is not built)."""
    saved = library_path(name).with_suffix(".log")
    return saved.read_text() if saved.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not library_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, (source, argtypes) in SIGNATURES.items():
            if source == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def entry(fn_name: str):
    """The C launch function `fn_name`, from the library of its source
    (looked up once: a wrapper's call is host time on every launch)."""
    fn = _entries.get(fn_name)
    if fn is None:
        fn = _entries[fn_name] = getattr(library(SIGNATURES[fn_name][0]),
                                         fn_name)
    return fn
