"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/repro_torch_kernels/`` at the root
of the checkout, then loaded with ``ctypes``.  Nothing is compiled when a
module is imported: the first launch builds every missing library, one
``nvcc`` per source, all started together.  A library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "NVCC_FLAGS", "build_all", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch_kernels"
SOURCES = ("frontier_expand", "late_gather", "frontier_pull",
           "spmm_segment", "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every library of SOURCES that is not built yet, in
    parallel.  Returns the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) per source it compiled; raises if a build fails."""
    pending = [(n, _library(n)) for n in SOURCES if not _library(n).exists()]
    if not pending:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, lib in pending:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build_all()
        _LIBS[name] = ctypes.CDLL(str(_library(name)))
    return _LIBS[name]
