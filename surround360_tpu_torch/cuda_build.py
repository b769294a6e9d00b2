"""The build of the port's CUDA sources (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/``, at first use, keyed by the hash of the source and the
shared headers (``csrc/*.cuh``). The modules that launch a source's
kernels (``ops/fused_window``, ``benchmarks/probe_common``) load the library
with ctypes and bind their own entry points.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "build_all", "ptxas_report"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
        "from surround360_tpu_torch/csrc/ at first use"
    )


def _so_path(source: str) -> str:
    """``_build/lib<stem>_<hash>.so``, keyed by the source and the shared
    headers (``csrc/*.cuh``) it may include."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """nvcc ``csrc/<source>`` into ``_build/`` (once per hash); returns the
    shared library's path. ptxas's report (registers, shared memory,
    spills per kernel) is kept beside it, see :func:`ptxas_report`."""
    so_path = _so_path(source)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        _find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, os.path.join(CSRC_DIR, source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc {source} failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    with open(f"{so_path}.ptxas.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, so_path)
    return so_path


def ptxas_report(source: str) -> list[str]:
    """ptxas's per-kernel lines (registers, shared memory, spill stores)
    from the build of ``source``; empty before it is built."""
    try:
        with open(f"{_so_path(source)}.ptxas.txt") as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return []
    keep = ("Compiling entry", "registers", "spill")
    return [ln.split("ptxas info    : ")[-1] for ln in lines if any(k in ln for k in keep)]


def build_all() -> dict[str, float]:
    """Build every source under ``csrc/``, one nvcc process each, all
    started together; returns source -> nvcc seconds (near 0 for a cached
    build)."""

    def timed(source):
        t0 = time.perf_counter()
        build(source)
        return time.perf_counter() - t0

    sources = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(timed, sources)))
