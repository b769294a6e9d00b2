"""Windowed samplers for dynamic warps (flow error fields, novel views,
the pole warp).

Port of ``surround360_tpu/ops/window_sampler.py``. The reference tiles the
output into (tr x tc) tiles and lets each tile read only a window of the
source around its footprint; taps beyond the window read weight 0
("constant") or are dropped ("clamp"). That window contract is part of
the result (a beyond-halo flow candidate reads zero samples), so the port
keeps it exactly: the same plans decide the same windows, and sampling is
a gather of the taps with the window mask (``fused_window.window_gather``).

- :func:`plan_windows` / :func:`plan_windows_budgeted`: the reference's
  static tile geometry, verbatim.
- :func:`sample_displaced` and :func:`make_window_sampler`: static windows
  at ``tile * stride - pad`` (plain torch).
- :func:`sample_displaced_residual`: displacement-following windows whose
  per-(tile, lead) origins track the tile's mean displacement; sampled by
  the fused window kernel with the window extents of the reference's
  Pallas route (8-row aligned y origins, ``bh`` grown to cover the
  alignment, exact x origins and width).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .fused_window import fused_window_sample, window_gather

__all__ = [
    "WindowPlan",
    "plan_windows",
    "plan_windows_budgeted",
    "sample_displaced",
    "sample_displaced_residual",
    "make_window_sampler",
]


class WindowPlan(NamedTuple):
    """Static tiling geometry for one (H, W) source / (Ho, Wo) output pair."""

    H: int
    W: int
    Ho: int
    Wo: int
    tr: int  # output tile rows
    tc: int  # output tile cols
    bh: int  # window height
    bw: int  # window width
    nty: int
    ntx: int
    pad_y: int  # top padding of the source (= offset of windows)
    pad_x: int
    interpolation: str
    border: str


def plan_windows(
    src_hw, out_hw, halo_y: int, halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128,
) -> WindowPlan:
    """Static tile/window geometry; halo_y/halo_x bound |sample - output
    position| per axis. One full-axis window where tiling wouldn't shrink
    the contraction."""
    H, W = src_hw
    Ho, Wo = out_hw
    margin = 2 if interpolation == "bicubic" else 1
    ey = halo_y + margin
    ex = halo_x + margin

    def axis_plan(n_src, n_out, t, e):
        if n_out < t or t + 2 * e + 1 >= n_src:
            return n_out, n_src, 1, 0
        nt = -(-n_out // t)
        return t, t + 2 * e + 1, nt, e

    tr_, bh, nty, pad_y = axis_plan(H, Ho, tr, ey)
    tc_, bw, ntx, pad_x = axis_plan(W, Wo, tc, ex)
    return WindowPlan(
        H, W, Ho, Wo, tr_, tc_, bh, bw, nty, ntx, pad_y, pad_x,
        interpolation, border,
    )


def plan_windows_budgeted(
    src_hw, out_hw, halo_y: int, halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128,
    elems_per_px: int = 1,
    max_window_elems: int = 64 * 1024 * 1024,
    max_tile_transient_elems: int = 384 * 1024 * 1024,
) -> WindowPlan:
    """plan_windows, with tiles grown until the reference's window stack
    fits its budget (the same growth rule, so the same windows)."""

    def transient(pl):
        return elems_per_px * pl.tr * pl.tc * min(pl.bh, pl.bw)

    while True:
        plan = plan_windows(
            src_hw, out_hw, halo_y, halo_x, interpolation, border, tr, tc
        )
        elems = plan.nty * plan.ntx * plan.bh * plan.bw * elems_per_px
        if elems <= max_window_elems:
            return plan
        dup_y = plan.bh / plan.tr if plan.nty > 1 else 1.0
        dup_x = plan.bw / plan.tc if plan.ntx > 1 else 1.0
        if dup_y <= 1.0 + 1e-9 and dup_x <= 1.0 + 1e-9:
            return plan
        grew = False
        for axis in ("y", "x") if dup_y >= dup_x else ("x", "y"):
            if axis == "y" and plan.nty <= 1:
                continue
            if axis == "x" and plan.ntx <= 1:
                continue
            tr2, tc2 = (tr * 2, tc) if axis == "y" else (tr, tc * 2)
            plan2 = plan_windows(
                src_hw, out_hw, halo_y, halo_x, interpolation, border,
                tr2, tc2,
            )
            if transient(plan2) <= max_tile_transient_elems:
                tr, tc = tr2, tc2
                grew = True
                break
        if not grew:
            return plan


def _static_origins(plan: WindowPlan, device):
    """Per-output-pixel window origins (Ho, Wo) in source coords: tile
    index * stride - pad (0 for an axis with a single window)."""
    p = plan
    r = torch.arange(p.Ho, device=device)
    c = torch.arange(p.Wo, device=device)
    oy = (r // p.tr) * p.tr - p.pad_y if p.nty > 1 else torch.zeros_like(r)
    ox = (c // p.tc) * p.tc - p.pad_x if p.ntx > 1 else torch.zeros_like(c)
    return oy[:, None].expand(p.Ho, p.Wo), ox[None, :].expand(p.Ho, p.Wo)


def _sample_static(img, plan: WindowPlan, x, y):
    """Static-window sampling. img (B..., C, H, W); x, y (E..., B..., Ho,
    Wo) absolute source coords (extra leading dims E share the source).
    Returns (E..., B..., C, Ho, Wo)."""
    p = plan
    lead = img.shape[:-3]
    C, H, W = img.shape[-3:]
    nb = len(lead)
    extra = x.shape[: x.ndim - 2 - nb]
    ne = len(extra)
    B = int(np.prod(lead, dtype=np.int64))
    E = int(np.prod(extra, dtype=np.int64))
    src = img.reshape(B, C, H, W)

    def lead_major(v):  # (E..., B..., Ho, Wo) -> (B, E * Ho * Wo)
        v = v.reshape((E, B, p.Ho * p.Wo))
        return v.transpose(0, 1).reshape(B, E * p.Ho * p.Wo)

    oy, ox = _static_origins(p, img.device)
    rep = lambda o: o.reshape(1, 1, -1).expand(B, E, -1).reshape(B, -1)
    out = window_gather(
        src, lead_major(x), lead_major(y), rep(oy), rep(ox),
        bh=p.bh, wx=p.bw, pad_y=0, pad_x=0, n_y=H, n_x=W,
        interpolation=p.interpolation, border=p.border,
    )  # (B, C, E * Ho * Wo)
    out = out.reshape(B, C, E, p.Ho, p.Wo).permute(2, 0, 1, 3, 4)
    return out.reshape(extra + lead + (C, p.Ho, p.Wo))


def sample_displaced(
    img, x, y, halo_y: int, halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128, max_window_elems: int = 0,
):
    """Static windows around each output tile. img (..., C, H, W); x, y
    (..., Ho, Wo) absolute coords with |x - col| <= halo_x, |y - row| <=
    halo_y. max_window_elems > 0 takes the budgeted plan, as the reference
    does. Returns (..., C, Ho, Wo)."""
    if max_window_elems:
        lead_elems = int(np.prod(img.shape[:-2], dtype=np.int64))
        plan = plan_windows_budgeted(
            img.shape[-2:], x.shape[-2:], halo_y, halo_x, interpolation,
            border, tr, tc, elems_per_px=lead_elems,
            max_window_elems=max_window_elems,
        )
    else:
        plan = plan_windows(
            img.shape[-2:], x.shape[-2:], halo_y, halo_x, interpolation,
            border, tr, tc,
        )
    return _sample_static(img, plan, x, y)


def make_window_sampler(img, plan: WindowPlan):
    """Reusable static-window sampler fn(x, y) over a fixed (B, C, H, W)
    source with a given plan (the flow passes its budgeted plan, the
    reference's XLA-route ``xla_plan``): coords (E..., B, Ho, Wo) ->
    (E..., B, C, Ho, Wo)."""

    def fn(x, y):
        return _sample_static(img, plan, x, y)

    return fn


def sample_displaced_residual(
    img, x, y, halo_y: int, halo_x: int, res_halo_y: int, res_halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128, site: str = "",
):
    """Displacement-following windows: each (tile, lead) window origin
    tracks the tile's rounded mean displacement (clamped to the global
    halos), so the window only covers the within-tile spread
    (``res_halo_*``) plus the interpolation margin. Taps beyond it read 0
    ("constant") or are dropped ("clamp"), as in the reference.

    img (..., C, H, W); x, y (..., Ho, Wo) absolute source coords sharing
    img's leading dims. Returns (..., C, Ho, Wo)."""
    p = plan_windows(
        img.shape[-2:], x.shape[-2:], res_halo_y, res_halo_x,
        interpolation, border, tr, tc,
    )
    if p.nty == 1 and p.ntx == 1:
        # one window spans the source; no origins to follow
        return _sample_static(img, p, x, y)
    m = 2 if interpolation == "bicubic" else 1
    res_ey, res_ex = res_halo_y + m, res_halo_x + m
    P_y, P_x = halo_y + m, halo_x + m

    lead = img.shape[:-2]  # includes channels
    if x.ndim - 2 != len(lead) - 1:
        raise ValueError("coords must share img's lead dims")
    L = int(np.prod(lead[:-1], dtype=np.int64)) if len(lead) > 1 else 1
    C = lead[-1]
    H, W = img.shape[-2:]

    # pad by the global halos (+ tail so the farthest clamped origin's
    # window stays in the array), exactly as the reference
    s_max_y = (p.nty - 1) * p.tr + (P_y - res_ey) + halo_y
    s_max_x = (p.ntx - 1) * p.tc + (P_x - res_ex) + halo_x
    pad_y_hi = max(P_y, s_max_y + p.bh - (P_y + H))
    pad_x_hi = max(P_x, s_max_x + p.bw - (P_x + W))
    padded = F.pad(
        img.reshape(L, C, H, W).float(), (P_x, pad_x_hi, P_y, pad_y_hi)
    )
    Hp, Wp = padded.shape[-2:]

    T = p.nty * p.ntx
    dev = img.device
    tiles = torch.arange(T, device=dev)
    ty = (tiles // p.ntx).to(torch.int32)
    tx = (tiles % p.ntx).to(torch.int32)

    def tile_coords(v):  # (..., Ho, Wo) -> (T, L, tr * tc), edge-padded
        v = v.reshape(L, p.Ho, p.Wo).float()
        v = F.pad(
            v[None], (0, p.ntx * p.tc - p.Wo, 0, p.nty * p.tr - p.Ho),
            mode="replicate",
        )[0]
        v = v.reshape(L, p.nty, p.tr, p.ntx, p.tc).permute(1, 3, 0, 2, 4)
        return v.reshape(T, L, p.tr * p.tc)

    xt = tile_coords(x)
    yt = tile_coords(y)

    # per-(tile, lead) mean displacement -> rounded origin in padded coords
    # (NaN sanitized before the clamp: a NaN origin would index garbage)
    base_y = (ty * p.tr).float() + (p.tr - 1) / 2.0
    base_x = (tx * p.tc).float() + (p.tc - 1) / 2.0
    d_y = torch.round(yt.mean(dim=-1) - base_y[:, None])
    d_x = torch.round(xt.mean(dim=-1) - base_x[:, None])
    d_y = torch.nan_to_num(d_y).clamp(-halo_y, halo_y).to(torch.int32)
    d_x = torch.nan_to_num(d_x).clamp(-halo_x, halo_x).to(torch.int32)
    s_y = (ty[:, None] * p.tr + (P_y - res_ey) + d_y).clamp(0, Hp - p.bh)
    s_x = (tx[:, None] * p.tc + (P_x - res_ex) + d_x).clamp(0, Wp - p.bw)
    # an axis whose single window spans the source must not follow
    if p.nty == 1:
        s_y = torch.full_like(s_y, P_y)
    if p.ntx == 1:
        s_x = torch.full_like(s_x, P_x)

    # the reference's kernel windows: y origins quantized down to 8 rows
    # with bh grown by the slack; x origins exact with width p.bw. (Its
    # extra zero padding for whole-window DMA reads is not needed here:
    # the kernel guards every read and counts out-of-array taps as 0.)
    bh_k = -(-(p.bh + 7) // 8) * 8
    bw_k = -(-(p.bw + 127) // 128) * 128
    out = fused_window_sample(
        padded,
        ((s_y // 8) * 8).to(torch.int32).contiguous(),
        s_x.to(torch.int32).contiguous(),
        (xt + float(P_x)).contiguous(),
        (yt + float(P_y)).contiguous(),
        bh=bh_k, bw=bw_k, pad_y=P_y, pad_x=P_x, n_y=H, n_x=W,
        interpolation=interpolation, border=border, base_bw=p.bw, site=site,
    )  # (T, L, C, P)
    out = out.reshape(p.nty, p.ntx, L * C, p.tr, p.tc)
    out = out.permute(2, 0, 3, 1, 4).reshape(L * C, p.nty * p.tr, p.ntx * p.tc)
    return out[..., : p.Ho, : p.Wo].reshape(lead + (p.Ho, p.Wo))
