"""Demosaic filters: bilinear, edge-aware (default), frequency-domain.

Port of ``surround360_tpu/isp/demosaic.py`` (reference: the three demosaic
paths of surround360_render/source/camera_isp/CameraIsp.h:89-335). The
per-pixel reflect-indexed loops are masked shifted adds on whole planes:
each plane is mirror-padded once and its shifts are slices of the padded
copy.

All functions take the mosaiced planes (..., H, W), any leading batch
dims, plus boolean Bayer masks red / green / blue (H, W) and the (H, 1)
mask of rows whose non-green pixel is red, and return (..., 3, H, W) RGB.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .resize import on_device

__all__ = ["demosaic_bilinear", "demosaic_edge_aware", "demosaic_frequency"]


class _Reflected:
    """A plane mirror-padded by ``radius`` with the reference's reflect()
    boundary (MathUtil.h:42-44: x < 0 -> -x, x >= n -> 2n - x - 2, the
    mirror that does not repeat the edge sample); ``shift(dy, dx)`` is
    x[..., reflect(i + dy), reflect(j + dx)], a view of the padded copy."""

    def __init__(self, x: torch.Tensor, radius: int):
        self.H, self.W = x.shape[-2:]
        if radius >= min(self.H, self.W):
            raise ValueError(f"planes of {self.H}x{self.W} are too small for a "
                             f"{radius} px neighbourhood")
        self.r = radius
        flat = x.reshape((-1, 1, self.H, self.W))
        padded = F.pad(flat, (radius,) * 4, mode="reflect")
        self.padded = padded.reshape(x.shape[:-2] + padded.shape[-2:])

    def shift(self, dy: int, dx: int) -> torch.Tensor:
        r = self.r
        return self.padded[..., r + dy : r + dy + self.H, r + dx : r + dx + self.W]

    def avg(self, offsets) -> torch.Tensor:
        acc = None
        for dy, dx in offsets:
            s = self.shift(dy, dx)
            acc = s if acc is None else acc + s
        return acc / len(offsets)


_DIAG = [(-1, -1), (1, -1), (-1, 1), (1, 1)]


def demosaic_bilinear(raw, red_mask, green_mask, blue_mask, red_green_row):
    """Bilinear demosaic (CameraIsp.h:89-148)."""
    zero = torch.zeros_like(raw)
    r = torch.where(red_mask, raw, zero)
    g = torch.where(green_mask, raw, zero)
    b = torch.where(blue_mask, raw, zero)

    p = _Reflected(raw, 1)
    cross = p.avg([(-1, 0), (1, 0), (0, -1), (0, 1)])
    diag = p.avg(_DIAG)
    horiz = p.avg([(0, -1), (0, 1)])
    vert = p.avg([(-1, 0), (1, 0)])

    # green at non-green sites: cross average of green neighbours
    g_out = torch.where(green_mask, g, cross)
    # at red sites: blue = diagonal average; at blue sites: red = diagonal
    r_out = torch.where(
        red_mask, r,
        torch.where(green_mask, torch.where(red_green_row, horiz, vert), diag),
    )
    b_out = torch.where(
        blue_mask, b,
        torch.where(green_mask, torch.where(red_green_row, vert, horiz), diag),
    )
    return torch.stack([r_out, g_out, b_out], dim=-3)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box sum with reflect boundary, via separable shifted adds."""
    p = _Reflected(x, radius)
    cols = None  # over the padded rows, so that the row pass has its halo
    for d in range(2 * radius + 1):
        s = p.padded[..., :, d : d + p.W]
        cols = s if cols is None else cols + s
    out = None
    for d in range(2 * radius + 1):
        s = cols[..., d : d + p.H, :]
        out = s if out is None else out + s
    return out


def demosaic_edge_aware(raw, red_mask, green_mask, blue_mask, red_green_row):
    """Edge-aware demosaic, the reference default (CameraIsp.h:181-335):
    H/V green estimates with 2nd-derivative correction, a 9x9 homogeneity
    vote between them, then constant-hue (R-G / B-G) interpolation."""
    zero = torch.zeros_like(raw)
    green = torch.where(green_mask, raw, zero)
    chroma = torch.where(green_mask, zero, raw)  # red or blue value at site

    pg, pc = _Reflected(green, 2), _Reflected(chroma, 2)
    up1, dn1 = pg.shift(-1, 0), pg.shift(1, 0)
    lf1, rt1 = pg.shift(0, -1), pg.shift(0, 1)
    up2g, dn2g = pg.shift(-2, 0), pg.shift(2, 0)
    lf2g, rt2g = pg.shift(0, -2), pg.shift(0, 2)
    up2c, dn2c = pc.shift(-2, 0), pc.shift(2, 0)
    lf2c, rt2c = pc.shift(0, -2), pc.shift(0, 2)

    # green sites keep their value; derivative = avg abs 2-step gradient
    dv_grn = (torch.abs(dn2g - green) + torch.abs(green - up2g)) / 2.0
    dh_grn = (torch.abs(rt2g - green) + torch.abs(green - lf2g)) / 2.0

    # chroma sites: interpolated green + 2nd-derivative correction from the
    # same-colour channel
    gv_chr = (up1 + dn1) / 2.0 + (2.0 * chroma - up2c - dn2c) / 4.0
    gh_chr = (lf1 + rt1) / 2.0 + (2.0 * chroma - lf2c - rt2c) / 4.0
    dv_chr = torch.abs(up1 - dn1) / 2.0 + torch.abs(-2.0 * chroma + up2c + dn2c) / 2.0
    dh_chr = torch.abs(lf1 - rt1) / 2.0 + torch.abs(-2.0 * chroma + lf2c + rt2c) / 2.0

    gv = torch.where(green_mask, green, gv_chr)
    gh = torch.where(green_mask, green, gh_chr)
    dv = torch.where(green_mask, dv_grn, dv_chr)
    dh = torch.where(green_mask, dh_grn, dh_chr)

    # homogeneity vote over a 9x9 window (w=4)
    votes = _box_sum((dh <= dv).to(raw.dtype), 4)
    g_full = torch.where(votes < (9 * 9) / 2, gv, gh)

    # constant-hue chroma interpolation on R-G / B-G differences
    diff = raw - g_full
    rmg = _Reflected(torch.where(red_mask, diff, zero), 2)
    bmg = _Reflected(torch.where(blue_mask, diff, zero), 2)

    def plus5(p):
        return (p.shift(0, 0) + p.shift(-2, 0) + p.shift(2, 0)
                + p.shift(0, -2) + p.shift(0, 2)) / 5.0

    def row6(p):
        # green-site neighbours on adjacent rows (CameraIsp.h:281-292);
        # the reference's tap list repeats (i1, j2) — kept verbatim
        return (p.shift(-1, -2) + p.shift(-1, 0) + p.shift(-1, 2)
                + p.shift(1, -2) + p.shift(1, 2) + p.shift(1, 2)) / 6.0

    def col6(p):
        return (p.shift(-2, -1) + p.shift(0, -1) + p.shift(2, -1)
                + p.shift(-2, 1) + p.shift(0, 1) + p.shift(2, 1)) / 6.0

    # red at: red sites -> plus5(rmg); green sites -> row/col 6-tap; blue
    # sites -> diag4(rmg). (blue symmetric)
    r_out = g_full + torch.where(
        red_mask, plus5(rmg),
        torch.where(green_mask, torch.where(red_green_row, col6(rmg), row6(rmg)),
                    rmg.avg(_DIAG)),
    )
    b_out = g_full + torch.where(
        blue_mask, plus5(bmg),
        torch.where(green_mask, torch.where(red_green_row, row6(bmg), col6(bmg)),
                    bmg.avg(_DIAG)),
    )
    r_out = torch.where(red_mask, raw, r_out)
    b_out = torch.where(blue_mask, raw, b_out)
    return torch.stack([r_out, g_full, b_out], dim=-3)


def _butterworth(x, cutoff, n):
    """Butterworth low-pass response (MonotonicTable.h:164-186 style):
    1 / (1 + (x / cutoff)^(2 n))."""
    return 1.0 / (1.0 + (x / cutoff) ** (2 * n))


@lru_cache(maxsize=8)
def _dct_matrix(n: int) -> np.ndarray:
    """(n, n) orthonormal DCT-II matrix D (float64 on the host, cast to
    float32): D @ x is the transform along an axis, D.T @ X its inverse."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.cos(np.pi * (2.0 * i + 1.0) * k / (2.0 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float32)


def demosaic_frequency(raw, red_mask, green_mask, blue_mask, red_green_row):
    """Frequency-domain demosaic (CameraIsp.h:150-178 + :1175-1211): DCT of
    each sparse colour plane (matrix products with the orthonormal DCT-II
    matrix on both axes), radial Butterworth gains with green sharpening
    and a chroma crossover blend, inverse DCT."""
    H, W = raw.shape[-2:]
    dev = raw.device
    dh = on_device(_dct_matrix, dev, H)
    dw = on_device(_dct_matrix, dev, W)
    zero = torch.zeros_like(raw)
    planes = torch.stack(
        [torch.where(m, raw, zero) for m in (red_mask, green_mask, blue_mask)], dim=-3
    )
    spec = dh @ planes @ dw.T
    R, G, B = spec.unbind(dim=-3)

    y = (torch.arange(H, dtype=torch.float32, device=dev) / (H - 1))[:, None]
    x = (torch.arange(W, dtype=torch.float32, device=dev) / (W - 1))[None, :]
    d = (x + y) * 1.2
    sharpen = d / 2.5 + 1.0
    # dFilter: 4th order, cutoff 1.0; dcFilter: order 2, cutoff 1.0
    g_gain = 2.0 * _butterworth(d, 1.0, 4) * sharpen
    rb_gain = 4.0 * _butterworth(d, 1.0, 4)
    alpha = _butterworth(d * 2.0 * 3.0, 1.0, 2)

    G2 = G * g_gain
    R2 = G2 + alpha * (R * rb_gain - G2)
    B2 = G2 + alpha * (B * rb_gain - G2)
    return dh.T @ torch.stack([R2, G2, B2], dim=-3) @ dw
