"""The least bytes a windowed-sampling call must move: a frozen copy of
``chip_smoke.py::call_bounds``' byte count, and the published peak it is
held to.

Bytes of one call: coordinates (two float32 a sample), window origins (two
int32 a window) and outputs (float32, each of O fields and C channels of a
sample) once, and once each source pixel (C float32) that a counted tap
reads with a nonzero weight (:func:`touched_px`).
"""

from __future__ import annotations

import torch

from .reference.taps import axis_taps

# NVIDIA H100 SXM HBM3, the data sheet's peak (at the card's 700 W limit)
HBM_BYTES_PER_S = 3.35e12


def touched_px(args, kw, tiles: int = 64) -> int:
    """Source pixels (summed over the leads) that the call's counted taps
    read with a nonzero weight, offsets included: the window or interior
    test, borders and non-finite samples as the kernels apply them, marked
    into one flag per pixel, ``tiles`` tiles at a time."""
    padded, sy, sx, xt, yt = args
    L, _, Hp, Wp = padded.shape
    T = xt.shape[0]
    offs = kw.get("offsets") or ((0, 0),)
    wx = kw["bw"] if (kw.get("base_bw") is None or kw.get("offsets")) else kw["base_bw"]
    my, mx = kw.get("off_my", 0), kw.get("off_mx", 0)
    cubic, clamp = kw["interpolation"] == "bicubic", kw["border"] == "clamp"
    seen = torch.zeros(L * Hp * Wp, dtype=torch.bool, device=xt.device)
    lead = torch.arange(L, device=xt.device)[None, :, None]
    for t0 in range(0, T, tiles):
        x, y = xt[t0:t0 + tiles], yt[t0:t0 + tiles]
        oy, ox = (o[t0:t0 + tiles] for o in (sy, sx))
        oy, ox = ((o[:, None] if o.ndim == 1 else o)[..., None] for o in (oy, ox))
        finite = torch.isfinite(x) & torch.isfinite(y)
        x, y = torch.where(finite, x, 0.0), torch.where(finite, y, 0.0)
        ty = axis_taps(y, oy + my, kw["bh"] - 2 * my, kw["pad_y"], kw["n_y"], cubic, clamp)
        tx = axis_taps(x, ox + mx, wx - 2 * mx, kw["pad_x"], kw["n_x"], cubic, clamp)
        for dy, dx in offs:
            for iy, wy in ty:
                iy = iy + dy
                for ix, wxx in tx:
                    ix = ix + dx
                    hit = (finite & (wy != 0) & (wxx != 0) & (iy >= 0) & (iy < Hp)
                           & (ix >= 0) & (ix < Wp))
                    seen[((lead * Hp + iy) * Wp + ix)[hit]] = True
    return int(seen.sum())


def call_bytes(args, kw) -> int:
    """The least bytes one call moves (see the module docstring). ``args``
    = (padded (L, C, Hp, Wp), sy, sx, xt (T, L, P), yt), ``kw`` the call's
    keyword arguments."""
    padded, sy, _, xt, _ = args
    C = padded.shape[1]
    T, L, P = xt.shape
    offs = kw.get("offsets")
    O = len(offs) if offs else 1
    samples = T * L * P
    return 8 * samples + 8 * sy.numel() + 4 * samples * O * C + 4 * C * touched_px(args, kw)
