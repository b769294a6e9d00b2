"""Fused windowed resampling: the CUDA kernels and their plain PyTorch twins.

Port of ``surround360_tpu/ops/pallas_remap.py::fused_window_sample``:

- :func:`fused_window_sample` (K1, its non-folded grid): for tile t, lead
  l, channel c and sample p, ``out[t, l, c, p]`` is the bicubic (Keys
  a=-0.75) or bilinear sample of ``padded[l, c]`` at
  ``(xt[t, l, p], yt[t, l, p])`` where only taps inside the (t, l) window
  ``[sy, sy + bh) x [sx, sx + wx)`` count (``wx = base_bw`` when given,
  the tight-x mode of the reference, else ``bw``). Kernel:
  ``csrc/fused_window_sample.cu``.
- :func:`fused_window_sample_folded` (its lead-folded grid): the window
  origins are per tile, shared by every lead. Without ``offsets`` (K2) it
  is K1 with those origins. With ``offsets`` (K3, bilinear only) it
  returns one field per integer offset (oy, ox): the bilinear taps of the
  base coordinate count only when they lie in the window's interior
  ``[sy + off_my, sy + bh - off_my) x [sx + off_mx, sx + bw - off_mx)``,
  and each reads the source at tap + (oy, ox). Kernel:
  ``csrc/fused_window_folded.cu``.

Dispatch: a CPU tensor goes to the twin (``*_reference``: a torch gather of
the same taps with the same window mask); a CUDA tensor launches the
kernel, building it with ``nvcc`` on first use, or raises. There is no
fallback from one to the other.

Each launch goes through ``cuda_build.launch``, which counts it by
(kernel, site), where kernel is one of :data:`KERNELS` and site is the
caller's label, so a run can show which call sites went through which
kernel. :func:`recorded` keeps per (kernel, site, offsets) the inputs and
output of the call with the most samples and the number of calls
(launches on the card, twin calls on the CPU), for later comparison with
the twin.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .. import cuda_build

__all__ = [
    "KERNELS",
    "fused_window_sample",
    "fused_window_sample_reference",
    "fused_window_sample_folded",
    "fused_window_sample_folded_reference",
    "window_gather",
    "axis_taps",
    "recorded",
]

# kernel name -> CUDA source under csrc/ (K2 and K3 share one source)
K1, K2, K3 = "fused_window_sample", "fused_window_folded", "fused_window_offsets"
KERNELS = (K1, K2, K3)
_SOURCES = {K1: "fused_window_sample.cu", K2: "fused_window_folded.cu",
            K3: "fused_window_folded.cu"}
MAX_OFFSETS = 16  # csrc/fused_window_folded.cu kMaxOffsets
_VP, _INT = ctypes.c_void_p, ctypes.c_int
# the entry points' arguments before the stream: pointers, then ints (K3:
# then the offsets)
_SAMPLE_ARGTYPES = [_VP] * 6 + [_INT] * 14
_FOLDED_ARGTYPES = [_VP] * 6 + [_INT] * 17 + [_VP]

_RECORD: dict | None = None  # the open record of :func:`recorded`
# guards _RECORD: frames may render on several threads
_LOCK = threading.Lock()


@contextlib.contextmanager
def recorded():
    """While open, keep per (kernel, site, offsets) of every K1-K3 call
    (:func:`_record`) the call with the most samples as (args, kw, out,
    calls of that key) in the dict this yields; the record open before is
    put back on exit."""
    global _RECORD
    with _LOCK:
        saved, _RECORD = _RECORD, {}
        record = _RECORD
    try:
        yield record
    finally:
        with _LOCK:
            _RECORD = saved


def _check_inputs(padded, sy, sx, xt, yt, interpolation, border, origin_shape):
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
    want = (T, L) if origin_shape == "TL" else (T,)
    for name, o in (("sy", sy), ("sx", sx)):
        if o.dtype != torch.int32 or tuple(o.shape) != want:
            raise ValueError(f"{name} must be {origin_shape} int32")
    devs = {t.device for t in (padded, sy, sx, xt, yt)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def axis_taps(v, origin, extent, pad, n, bicubic, clamp):
    """Torch twin of the kernels' ``axis_taps``: list of (index, weight)
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
        ok = (i >= origin) & (i < origin + extent)
        taps.append((torch.where(ok, i, 0), torch.where(ok, w, 0.0)))
    return taps


def window_gather(
    src, x, y, oy, ox, *, bh, wx, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant", margin_y=0, margin_x=0,
    offsets=None,
):
    """The twins' core, for any sample layout. src (L, C, Hp, Wp); x, y
    (L, S) sample coords and oy, ox (L, S) window origins, all in the
    padded units of ``src``. Returns (L, C, S): taps summed over x then y,
    each counted only inside its window [oy, oy + bh) x [ox, ox + wx).

    With ``offsets`` ((dy, dx), ...) returns (L, O, C, S): a tap counts when
    it lies in the window's interior (the window less ``margin_y`` /
    ``margin_x`` on each side) and reads the source at tap + (dy, dx), 0
    outside the array."""
    L, C, Hp, Wp = src.shape
    S = x.shape[-1]
    bicubic = interpolation == "bicubic"
    clamp = border == "clamp"
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, 0.0)
    y = torch.where(finite, y, 0.0)
    ty = axis_taps(y, oy + margin_y, bh - 2 * margin_y, pad_y, n_y, bicubic, clamp)
    tx = axis_taps(x, ox + margin_x, wx - 2 * margin_x, pad_x, n_x, bicubic, clamp)
    flat = src.reshape(L, C, Hp * Wp)
    fields = []
    for dy, dx in offsets or ((0, 0),):
        out = torch.zeros((L, C, S), dtype=torch.float32, device=src.device)
        for iy, wy in ty:
            iy = iy + dy
            oky = (iy >= 0) & (iy < Hp)
            row = torch.zeros_like(out)
            for ix, wxx in tx:
                ix = ix + dx
                ok = oky & (ix >= 0) & (ix < Wp)
                idx = torch.where(ok, iy * Wp + ix, 0)[:, None, :].expand(L, C, S)
                w = torch.where(ok, wxx, 0.0)
                row += w[:, None, :] * torch.gather(flat, 2, idx)
            out += wy[:, None, :] * row
        fields.append(out * finite[:, None, :])
    return torch.stack(fields, dim=1) if offsets is not None else fields[0]


def _lead_major(a, L):  # (T, L, P) -> (L, T * P)
    return a.permute(1, 0, 2).reshape(L, -1)


def fused_window_sample_reference(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant", base_bw=None,
):
    """Plain PyTorch twin of K1 (same signature and semantics)."""
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border, "TL")
    L, C = padded.shape[:2]
    T, _, P = xt.shape

    def origins(o):  # (T, L) -> (L, T * P)
        return o.t().reshape(L, T, 1).expand(L, T, P).reshape(L, T * P)

    out = window_gather(
        padded, _lead_major(xt, L), _lead_major(yt, L), origins(sy),
        origins(sx), bh=bh, wx=bw if base_bw is None else base_bw,
        pad_y=pad_y, pad_x=pad_x, n_y=n_y, n_x=n_x,
        interpolation=interpolation, border=border,
    )
    return out.reshape(L, C, T, P).permute(2, 0, 1, 3).contiguous()


def _record(kernel, site, args, kw, out):
    """Keep the call with the most samples per (kernel, site, offsets) in
    the open record (:func:`recorded`), as (args, kw, out, calls of that
    key)."""
    with _LOCK:
        if _RECORD is None:
            return
        key = (kernel, site, kw.get("offsets"))
        n = _RECORD[key][3] + 1 if key in _RECORD else 1
        if key not in _RECORD or args[3].numel() > _RECORD[key][0][3].numel():
            _RECORD[key] = (args, kw, out, n)
        else:
            _RECORD[key] = _RECORD[key][:3] + (n,)


def fused_window_sample(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bicubic", border="constant", base_bw=None, site="",
):
    """K1: windowed sampling, (T, L, C, P) float32 (see the module
    docstring).

    padded (L, C, Hp, Wp) f32; sy, sx (T, L) int32 window origins in
    padded coords; xt, yt (T, L, P) f32 sample coords in padded units.
    ``site`` labels the caller in ``cuda_build.LAUNCHES``."""
    kw = dict(
        bh=bh, bw=bw, pad_y=pad_y, pad_x=pad_x, n_y=n_y, n_x=n_x,
        interpolation=interpolation, border=border, base_bw=base_bw,
    )
    if padded.device.type == "cpu":
        out = fused_window_sample_reference(padded, sy, sx, xt, yt, **kw)
        _record(K1, site, [padded, sy, sx, xt, yt], kw, out)
        return out
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device: {padded.device}")
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border, "TL")
    args = [t.contiguous() for t in (padded, sy, sx, xt, yt)]
    fn = cuda_build.entry(_SOURCES[K1], "s360_fused_window_sample", _SAMPLE_ARGTYPES)
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    out = torch.empty((T, L, C, P), dtype=torch.float32, device=padded.device)
    cuda_build.launch(K1, site, fn, [*args, out], [
        T, L, C, Hp, Wp, P, bh, bw if base_bw is None else base_bw,
        pad_y, pad_x, n_y, n_x, int(interpolation == "bicubic"), int(border == "clamp"),
    ], padded.device)
    _record(K1, site, args, kw, out)
    return out


def _check_folded(offsets, interpolation, off_my, off_mx, bh, wx):
    if offsets is None:
        if off_my or off_mx:
            raise ValueError("offset margins need offsets")
        return
    if interpolation != "bilinear":
        raise ValueError("offsets mode is bilinear only")
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if any(abs(dy) > off_my or abs(dx) > off_mx for dy, dx in offsets):
        raise ValueError("an offset exceeds its margin")
    if bh <= 2 * off_my or wx <= 2 * off_mx:
        raise ValueError("the window must be wider than both margins")


def fused_window_sample_folded_reference(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bilinear", border="clamp", offsets=None, base_bw=None,
    off_my=0, off_mx=0,
):
    """Plain PyTorch twin of K2 / K3 (same signature and semantics)."""
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border, "T")
    wx = bw if (base_bw is None or offsets is not None) else base_bw
    _check_folded(offsets, interpolation, off_my, off_mx, bh, wx)
    L, C = padded.shape[:2]
    T, _, P = xt.shape

    def origins(o):  # (T,) -> (L, T * P)
        return o.reshape(1, T, 1).expand(L, T, P).reshape(L, T * P)

    out = window_gather(
        padded, _lead_major(xt, L), _lead_major(yt, L), origins(sy),
        origins(sx), bh=bh, wx=wx, pad_y=pad_y, pad_x=pad_x, n_y=n_y,
        n_x=n_x, interpolation=interpolation, border=border,
        margin_y=off_my, margin_x=off_mx,
        offsets=None if offsets is None else tuple(offsets),
    )
    if offsets is None:
        return out.reshape(L, C, T, P).permute(2, 0, 1, 3).contiguous()
    O = len(offsets)
    return out.reshape(L, O, C, T, P).permute(3, 0, 1, 2, 4).contiguous()


def fused_window_sample_folded(
    padded, sy, sx, xt, yt, *, bh, bw, pad_y, pad_x, n_y, n_x,
    interpolation="bilinear", border="clamp", offsets=None, base_bw=None,
    off_my=0, off_mx=0, site="",
):
    """K2 / K3: lead-folded windowed sampling (see the module docstring).

    padded (L, C, Hp, Wp) f32; sy, sx (T,) int32 per-tile window origins
    in padded coords, shared by every lead; xt, yt (T, L, P) f32 sample
    coords in padded units. Without ``offsets`` the window is
    ``[sy, sy + bh) x [sx, sx + (base_bw or bw))`` and the result is
    (T, L, C, P). With ``offsets`` ((oy, ox), ...), at most
    :data:`MAX_OFFSETS`, each within the margins ``off_my`` / ``off_mx``,
    the window is ``bh x bw`` and the result is (T, L, O, C, P).
    ``site`` labels the caller in ``cuda_build.LAUNCHES``."""
    kw = dict(
        bh=bh, bw=bw, pad_y=pad_y, pad_x=pad_x, n_y=n_y, n_x=n_x,
        interpolation=interpolation, border=border,
        offsets=None if offsets is None else tuple(offsets),
        base_bw=base_bw, off_my=off_my, off_mx=off_mx,
    )
    if padded.device.type == "cpu":
        out = fused_window_sample_folded_reference(padded, sy, sx, xt, yt, **kw)
        _record(K2 if offsets is None else K3, site, [padded, sy, sx, xt, yt], kw, out)
        return out
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device: {padded.device}")
    _check_inputs(padded, sy, sx, xt, yt, interpolation, border, "T")
    wx = bw if (base_bw is None or offsets is not None) else base_bw
    _check_folded(offsets, interpolation, off_my, off_mx, bh, wx)
    kernel = K2 if offsets is None else K3
    args = [t.contiguous() for t in (padded, sy, sx, xt, yt)]
    fn = cuda_build.entry(_SOURCES[kernel], "s360_fused_window_folded", _FOLDED_ARGTYPES)
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    offs = kw["offsets"] or ((0, 0),)
    O = len(offs)
    off_yx = (ctypes.c_int * (2 * O))(*[v for o in offs for v in o])
    shape = (T, L, C, P) if offsets is None else (T, L, O, C, P)
    out = torch.empty(shape, dtype=torch.float32, device=padded.device)
    cuda_build.launch(kernel, site, fn, [*args, out], [
        T, L, C, Hp, Wp, P, bh, wx, off_my, off_mx, pad_y, pad_x,
        n_y, n_x, int(interpolation == "bicubic"), int(border == "clamp"), O, off_yx,
    ], padded.device)
    _record(kernel, site, args, kw, out)
    return out
