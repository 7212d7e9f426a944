"""Build and load the port's CUDA kernels.

Each source in ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go into
``kernels/build/`` (listed in ``.gitignore``) under a name that carries a
hash of the sources and flags, so an edited source never loads a stale
library. All sources compile in parallel, one ``nvcc`` each, on first use.
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
SOURCES = ("swiglu", "moe_gmm", "moe_gather")
HEADERS = ("ffn_core.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every pointer and the stream as c_void_p, sizes as c_int
SIGNATURES = {
    "swiglu": ("swiglu_ffn_launch", [_P] * 6 + [_I] * 5 + [_P]),
    "moe_gmm": ("moe_gmm_ragged_launch", [_P] * 7 + [_I] * 7 + [_P]),
    "moe_gather": ("moe_gather_launch", [_P] * 7 + [_I] * 7 + [_P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_log: dict[str, str] = {}


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


def _lib_path(name: str) -> Path:
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
        out = _lib_path(name)
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
        _build_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """nvcc/ptxas output of this process's build of `name` ('' if the
    library was already built)."""
    return _build_log.get(name, "")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def entry(name: str):
    """The C launch function of csrc/<name>.cu."""
    return getattr(library(name), SIGNATURES[name][0])
