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
import re
import shutil
import subprocess
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "build_all", "ptxas_report",
           "kernel_resources", "hmma_counts"]

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


def kernel_resources(source: str) -> dict[str, dict]:
    """Per kernel of ``source``'s build (mangled name), ptxas's registers
    and spill bytes: {name: {"registers", "spill_stores", "spill_loads"}}."""
    out, name = {}, None
    for line in ptxas_report(source):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
    return out


def hmma_counts(source: str) -> dict[str, int]:
    """Per kernel of ``source``'s built library (mangled name), the count
    of tensor-core (HMMA) instructions in its SASS, read with the
    toolkit's ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build(source)], capture_output=True,
                          text=True, check=True).stdout
    instr = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?HMMA\b")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and instr.search(line):
            counts[name] += 1
    return counts


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
