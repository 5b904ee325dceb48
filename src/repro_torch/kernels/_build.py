"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface, at first use, into ``build/`` beside this file
(listed in ``.gitignore``). The file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Sources build in parallel, one ``nvcc`` each. The libraries are
loaded with ``ctypes``; every entry point returns ``cudaGetLastError()``
after its launch, and :func:`check` raises when that is not 0.

Nothing here runs at import: importing the package needs no CUDA toolkit,
and a CPU tensor never reaches ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

#: library name → (source file, {entry point: argtypes})
LIBRARIES: Dict[str, tuple] = {
    "rb_binning": ("rb_binning.cu", {
        "rb_binning_launch": [_P] * 6 + [_I] * 4 + [_P]}),
    "ell_spmm": ("ell_spmm.cu", {
        "z_matmul_launch": [_P] * 4 + [_I] * 4 + [_P],
        "zt_matmul_launch": [_P] * 8 + [ctypes.c_longlong] + [_I] * 3
        + [_P]}),
    "kmeans_assign": ("kmeans_assign.cu", {
        "kmeans_assign_launch": [_P] * 4 + [_I] * 3 + [_P]}),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / LIBRARIES[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every library that is not built yet, all in parallel.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the libraries
    built by this call (``ptxas`` holds ``-Xptxas=-v``'s register and
    shared-memory report). Raises with the compiler's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name, (src, _) in LIBRARIES.items():
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{text}")
            continue
        os.replace(tmp, out)           # atomic: concurrent builds agree
        report[name] = {"seconds": seconds, "ptxas": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError "
                           f"{code}")
