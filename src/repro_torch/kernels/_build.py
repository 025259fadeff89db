"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>.so`` at the repository root: a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
A library is rebuilt when its source, or a header of ``csrc/`` that the
source includes, is newer.  :func:`build_all` starts
one ``nvcc`` per stale source, all at once, and waits for every one of
them.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.tracing import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("delta_apply", "mlp_apply", "extremum_apply", "embedding_bag",
           "segment_mm", "flash_attention", "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output per source from the last build (ptxas register and shared
# memory report), for the smoke run to print
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _inputs(name: str) -> list[Path]:
    """The source of ``name`` and the headers of ``csrc/`` it includes."""
    src = CSRC / f"{name}.cu"
    headers = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src] + [CSRC / h for h in headers]


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime
                                         for p in _inputs(name)))


def build_all(names=SOURCES) -> float:
    """Compile every stale source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    stale = [name for name in names if _stale(name)]
    if not stale:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        # build under a private name, then rename: a concurrent build
        # never loads a half-written library
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode:
            failed.append(f"--- {name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    if name not in _LIBS:
        with span("kernels.load", setup=True):
            build_all((name,))
            _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
