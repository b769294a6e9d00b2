"""Fused windowed resampling: the CUDA kernel and its plain PyTorch twin.

Port of ``surround360_tpu/ops/pallas_remap.py::fused_window_sample`` (its
non-folded grid, which every main-path call uses). For tile t, lead l,
channel c and sample p, ``out[t, l, c, p]`` is the bicubic (Keys a=-0.75)
or bilinear sample of ``padded[l, c]`` at ``(xt[t, l, p], yt[t, l, p])``
where only taps inside the (t, l) window
``[sy, sy + bh) x [sx, sx + wx)`` count (``wx = base_bw`` when given, the
tight-x mode of the reference, else ``bw``). See
``csrc/fused_window_sample.cu`` for the kernel and its design notes.

Dispatch: a CPU tensor goes to :func:`fused_window_sample_reference` (the
twin: a torch gather of the same taps with the same window mask); a CUDA
tensor launches the kernel, building it with ``nvcc`` on first use, or
raises. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches and ``SITE_LAUNCHES`` tallies them by
the caller's ``site`` label, so a run can show which call sites went
through the kernel. ``RECORD``, when set to a dict, keeps the first
launch's inputs and output per site for later comparison with the twin.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = [
    "fused_window_sample",
    "fused_window_sample_reference",
    "window_gather",
    "reset_launch_counts",
    "LAUNCHES",
    "SITE_LAUNCHES",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_window_sample.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")

LAUNCHES = 0
SITE_LAUNCHES: collections.Counter = collections.Counter()
RECORD: dict | None = None
BUILD_SECONDS: float | None = None
_lib = None


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    SITE_LAUNCHES.clear()


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the fused window kernel is built "
        "from csrc/fused_window_sample.cu at first use"
    )


def _load_library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, BUILD_SECONDS
    if _lib is not None:
        return _lib
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libfused_window_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [
            _find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-o", tmp, _SOURCE,
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so_path)
        BUILD_SECONDS = time.perf_counter() - t0
    else:
        BUILD_SECONDS = 0.0
    lib = ctypes.CDLL(so_path)
    fn = lib.s360_fused_window_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    _lib = lib
    return lib


def _check_inputs(padded, sy, sx, xt, yt, interpolation, border):
    if interpolation not in ("bicubic", "bilinear"):
        raise ValueError(f"unknown interpolation: {interpolation}")
    if border not in ("constant", "clamp"):
        raise ValueError(f"unsupported border: {border}")
    if padded.dtype != torch.float32 or padded.ndim != 4:
        raise ValueError("padded must be (L, C, Hp, Wp) float32")
    L = padded.shape[0]
    if xt.dtype != torch.float32 or yt.dtype != torch.float32:
        raise ValueError("xt/yt must be float32")
    if xt.ndim != 3 or xt.shape != yt.shape or xt.shape[1] != L:
        raise ValueError(f"xt/yt must be (T, L, P); got {tuple(xt.shape)}")
    T = xt.shape[0]
    for name, o in (("sy", sy), ("sx", sx)):
        if o.dtype != torch.int32 or tuple(o.shape) != (T, L):
            raise ValueError(f"{name} must be (T, L) int32")
    devs = {t.device for t in (padded, sy, sx, xt, yt)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _axis_taps(v, origin, extent, pad, n, limit, bicubic, clamp):
    """Torch twin of the kernel's ``axis_taps``: list of (index, weight)
    with masked taps at index 0 / weight 0."""
    if clamp and not bicubic:
        v = torch.clamp(v - pad, 0.0, n - 1.0) + pad
    elif clamp:
        v = torch.clamp(v, pad - 3.0, pad + n + 2.0)
    f = torch.floor(v)
    t = v - f
    a = -0.75

    def k01(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def k12(s):
        return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

    if bicubic:
        ws = [k12(t + 1.0), k01(t), k01(1.0 - t), k12(2.0 - t)]
        offs = (-1, 0, 1, 2)
    else:
        ws = [1.0 - t, t]
        offs = (0, 1)
    origin_f = origin.to(v.dtype)
    f = torch.minimum(torch.maximum(f, origin_f - 3.0), origin_f + (extent + 1))
    i0 = f.to(torch.int64)
    origin = origin.to(torch.int64)
    taps = []
    for off, w in zip(offs, ws):
        i = i0 + off
        if clamp and bicubic:
            i = torch.clamp(i, pad, pad + n - 1)
        ok = (i >= origin) & (i < origin + extent) & (i >= 0) & (i < limit)
        taps.append((torch.where(ok, i, 0), torch.where(ok, w, 0.0)))
    return taps


def window_gather(
    src, x, y, oy, ox, *, bh, wx, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant",
):
    """The twin's core, for any sample layout. src (L, C, Hp, Wp); x, y
    (L, S) sample coords and oy, ox (L, S) window origins, all in the
    padded units of ``src``. Returns (L, C, S): taps summed over x then y,
    each counted only inside its window [oy, oy + bh) x [ox, ox + wx)."""
    L, C, Hp, Wp = src.shape
    S = x.shape[-1]
    bicubic = interpolation == "bicubic"
    clamp = border == "clamp"
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, 0.0)
    y = torch.where(finite, y, 0.0)
    ty = _axis_taps(y, oy, bh, pad_y, n_y, Hp, bicubic, clamp)
    tx = _axis_taps(x, ox, wx, pad_x, n_x, Wp, bicubic, clamp)
    flat = src.reshape(L, C, Hp * Wp)
    out = torch.zeros((L, C, S), dtype=torch.float32, device=src.device)
    for iy, wy in ty:
        row = torch.zeros_like(out)
        for ix, wxx in tx:
            idx = (iy * Wp + ix)[:, None, :].expand(L, C, S)
            row += wxx[:, None, :] * torch.gather(flat, 2, idx)
        out += wy[:, None, :] * row
    return out * finite[:, None, :]


def fused_window_sample_reference(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant", base_bw=None,
):
    """Plain PyTorch twin of the kernel (same signature and semantics)."""
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border)
    L, C = padded.shape[:2]
    T, _, P = xt.shape

    def lead_major(a):  # (T, L, P) -> (L, T * P)
        return a.permute(1, 0, 2).reshape(L, T * P)

    def origins(o):  # (T, L) -> (L, T * P)
        return o.t().reshape(L, T, 1).expand(L, T, P).reshape(L, T * P)

    out = window_gather(
        padded, lead_major(xt), lead_major(yt), origins(sy), origins(sx),
        bh=bh, wx=bw if base_bw is None else base_bw, pad_y=pad_y,
        pad_x=pad_x, n_y=n_y, n_x=n_x, interpolation=interpolation,
        border=border,
    )
    return out.reshape(L, C, T, P).permute(2, 0, 1, 3).contiguous()


def fused_window_sample(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant", base_bw=None, site="",
):
    """Windowed sampling, (T, L, C, P) float32 (see the module docstring).

    padded (L, C, Hp, Wp) f32; sy, sx (T, L) int32 window origins in
    padded coords; xt, yt (T, L, P) f32 sample coords in padded units.
    ``site`` labels the caller in ``SITE_LAUNCHES``."""
    global LAUNCHES
    kw = dict(
        bh=bh, bw=bw, pad_y=pad_y, pad_x=pad_x, n_y=n_y, n_x=n_x,
        interpolation=interpolation, border=border, base_bw=base_bw,
    )
    if padded.device.type == "cpu":
        return fused_window_sample_reference(padded, sy, sx, xt, yt, **kw)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device: {padded.device}")
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border)
    args = [t.contiguous() for t in (padded, sy, sx, xt, yt)]
    lib = _load_library()
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    out = torch.empty((T, L, C, P), dtype=torch.float32, device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.s360_fused_window_sample(
            *[a.data_ptr() for a in args], out.data_ptr(),
            T, L, C, Hp, Wp, P, bh, bw if base_bw is None else base_bw,
            pad_y, pad_x, n_y, n_x,
            int(interpolation == "bicubic"), int(border == "clamp"), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_window_sample launch failed: CUDA error {err}")
    LAUNCHES += 1
    SITE_LAUNCHES[site] += 1
    if RECORD is not None and site not in RECORD:
        RECORD[site] = (args, kw, out)
    return out
