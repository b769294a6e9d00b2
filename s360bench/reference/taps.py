"""The windowed samplers as plain tap gathers: the reference's stand-in for
the program's hand kernels.

For tile t, lead l, channel c and sample p, ``fused_window_sample`` returns
the bicubic (Keys a=-0.75) or bilinear sample of ``padded[l, c]`` at
``(xt[t, l, p], yt[t, l, p])`` counting only the taps inside the (t, l)
window ``[sy, sy + bh) x [sx, sx + wx)``. ``fused_window_sample_folded``
takes one window origin per tile, shared by every lead, and with
``offsets`` returns one bilinear field per integer offset (oy, ox), each
tap counted inside the window's interior and read at tap + (oy, ox). The
window is part of the result: a tap beyond it reads nothing.
"""

from __future__ import annotations

import torch

MAX_OFFSETS = 16


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


def fused_window_sample(padded, sy, sx, xt, yt, *, site="", **kw):
    """Windowed sampling, (T, L, C, P) float32; ``site`` is ignored."""
    return fused_window_sample_reference(padded, sy, sx, xt, yt, **kw)


def fused_window_sample_folded(padded, sy, sx, xt, yt, *, site="", **kw):
    """Lead-folded windowed sampling, (T, L, C, P) or with offsets
    (T, L, O, C, P) float32; ``site`` is ignored."""
    return fused_window_sample_folded_reference(padded, sy, sx, xt, yt, **kw)
