"""The port's CUDA sources (``csrc/*.cu``): their build, their launches
and the one account of those launches.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/``, at first use, keyed by the hash of the source and the
shared headers (``csrc/*.cuh``). :func:`entry` loads a built library once
and binds one of its C entry points; :func:`launch` calls it on the
device's current stream, raises when the launch is refused and otherwise
counts it. Every hand kernel (K1-K3 in ``ops/fused_window``, the K4 / K5
probes in ``benchmarks/``) launches through it.

``LAUNCHES`` counts the launches by (kernel, site), where the site is the
caller's label (a probe's variant); each launch also counts as
``launches.<kernel>`` in the innermost span of ``utils/tracing.py`` while
tracing is on.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from .utils import tracing

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "build_all", "ptxas_report",
           "kernel_resources", "hmma_counts", "entry", "launch", "LAUNCHES",
           "launch_count", "reset_launch_counts"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict = {}  # source file -> loaded ctypes library
# guards LAUNCHES and _LIBS: frames may render on several threads
_LOCK = threading.Lock()


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


def entry(source: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``source``'s library, built and loaded
    once, bound to ``argtypes`` followed by the stream; it returns a CUDA
    error code."""
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(build(source))
        fn = getattr(_LIBS[source], name)
        if fn.argtypes is None:
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, site: str, fn, tensors, scalars, device) -> None:
    """Call the entry point ``fn`` on ``tensors``' data pointers, then
    ``scalars`` and the current stream of ``device``; raise when the launch
    is refused, else count it (:func:`_count`). Tensors and scalars come
    apart, so that the launch path tests no argument's type (a host cost
    paid at every launch)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} ({site}) launch failed: CUDA error {err}")
    _count(kernel, site)


def _count(kernel: str, site: str) -> None:
    with _LOCK:
        LAUNCHES[(kernel, site)] += 1
    tracing.count("launches." + kernel)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_count(kernel: str | None = None, site: str | None = None) -> int:
    """Launches of ``kernel`` (any when None) at ``site`` (any when None)."""
    return sum(n for (k, s), n in LAUNCHES.items()
               if kernel in (None, k) and site in (None, s))
