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
- :func:`sample_displaced`: static windows at ``tile * stride - pad``,
  sampled by the fused window kernel (K1) with per-tile origins.
- :func:`make_window_sampler`: the flow's reusable sampler, with the
  reference's two routes: fused (the lead-folded kernels K2 / K3, where
  the reference takes Pallas) or plain (its XLA fallback), chosen by the
  shape-only predicate :func:`fused_route_plan`.
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

from .fused_window import (
    fused_window_sample,
    fused_window_sample_folded,
    window_gather,
)
from .resize import device_constant, on_device

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


def _untile(out, p: WindowPlan, lead):
    """(T, L, C, tr * tc) kernel output -> lead + (Ho, Wo), lead = the
    source's leading dims with its channels."""
    LC = out.shape[1] * out.shape[2]
    out = out.reshape(p.nty, p.ntx, LC, p.tr, p.tc)
    out = out.permute(2, 0, 3, 1, 4).reshape(LC, p.nty * p.tr, p.ntx * p.tc)
    return out[..., : p.Ho, : p.Wo].reshape(tuple(lead) + (p.Ho, p.Wo))


def _sample_static_fused(img, plan: WindowPlan, x, y, site: str):
    """Static-window sampling by the fused window kernel. img (B..., C, H,
    W); x, y (B..., Ho, Wo). Tile (ty, tx)'s window starts at (ty * tr -
    pad_y, tx * tc - pad_x) of the source itself: the first and last
    windows reach past the array, where the kernel reads nothing. Values
    equal :func:`_sample_static`'s."""
    p = plan
    lead = img.shape[:-2]  # includes channels
    C, H, W = img.shape[-3:]
    if tuple(x.shape[:-2]) != tuple(lead[:-1]):
        raise ValueError("coords must share img's lead dims")
    L = int(np.prod(lead[:-1], dtype=np.int64))
    tiles = torch.arange(p.nty * p.ntx, device=img.device)
    sy = (tiles // p.ntx) * p.tr - p.pad_y if p.nty > 1 else tiles * 0
    sx = (tiles % p.ntx) * p.tc - p.pad_x if p.ntx > 1 else tiles * 0
    out = fused_window_sample(
        img.reshape(L, C, H, W).float(),
        sy.to(torch.int32)[:, None].expand(-1, L).contiguous(),
        sx.to(torch.int32)[:, None].expand(-1, L).contiguous(),
        _tile_coords(x.reshape(L, p.Ho, p.Wo), p),
        _tile_coords(y.reshape(L, p.Ho, p.Wo), p),
        bh=p.bh, bw=p.bw, pad_y=0, pad_x=0, n_y=H, n_x=W,
        interpolation=p.interpolation, border=p.border, site=site,
    )  # (T, L, C, P)
    return _untile(out, p, lead)


def sample_displaced(
    img, x, y, halo_y: int, halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128, max_window_elems: int = 0, site: str = "",
):
    """Static windows around each output tile. img (..., C, H, W); x, y
    (..., Ho, Wo) absolute coords with |x - col| <= halo_x, |y - row| <=
    halo_y. max_window_elems > 0 takes the budgeted plan, as the reference
    does. ``site`` labels the kernel's launches. Returns (..., C, Ho, Wo)."""
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
    return _sample_static_fused(img, plan, x, y, site)


# The reference's model of one fused-kernel step's TPU memory
# (pallas_remap.py:57-100) and its budget. Here it sizes nothing: it is
# the fused route's admission test, which decides the windows a call gets
# and so its values.
_ROUTE_STEP_BUDGET = 28 * 1024 * 1024


def _route_step_bytes(C, P, bh, bw, L, group, compute_dtype, n_off, n_ox):
    """``_step_vmem_bytes`` of the lead-folded grid."""
    Pg = -(-P // group)
    dt = 2 if compute_dtype == "bfloat16" else 4
    win = L * C * bh * bw * 4
    blocks = 2 * (2 * L * P * 4) + 2 * (L * n_off * C * P * 4)
    onehots = Pg * (bh + bw) * dt + Pg * max(bh, bw) * 4
    return win + onehots + n_ox * Pg * C * bh * 4 + blocks


def _route_group(C, P, bh, bw, L, compute_dtype, n_off=1, n_ox=1) -> int:
    """``_pick_kernel_group``: the smallest admissible split of P into
    128-multiples, or 0 when none fits the step budget."""
    if P % 128:
        return 0
    for G in range(1, P // 128 + 1):
        if P % G or (P // G) % 128:
            continue
        if _route_step_bytes(
            C, P, bh, bw, L, G, compute_dtype, n_off, n_ox
        ) <= _ROUTE_STEP_BUDGET:
            return G
    return 0


# precision strings the reference counts as multi-pass f32 (its
# ``is_f32_class`` after ``resolve``); any other takes its bf16 step model
_F32_CLASS = {"float32", "highest", "bfloat16_3x", "high", "tensorfloat32"}


def fused_route_plan(
    B, C, src_hw, out_hw, halo_y, halo_x, interpolation, border, tr, tc,
    precision="float32", backend="auto", min_out_px=16384, offsets=None,
):
    """The route predicate of :func:`make_window_sampler`: the plan of the
    fused (kernel) route, or None for the plain route. A function of the
    shapes and static arguments only, with the reference's conditions
    (window_sampler.py:911-942): enough output pixels (unless forced),
    8-row tiles, 128-column tiles with offsets across several x tiles, and
    a window that passes the reference's step-memory admission test."""
    if backend not in ("auto", "xla", "kernel"):
        raise ValueError(f"unknown backend: {backend}")
    Ho, Wo = out_hw
    if backend == "xla" or (Ho * Wo < min_out_px and backend != "kernel"):
        return None
    plan = plan_windows(src_hw, out_hw, halo_y, halo_x, interpolation,
                        border, tr, tc)
    if plan.tr % 8 or (offsets and plan.ntx > 1 and plan.tc % 128):
        return None
    my, mx = _offset_margins(offsets)
    bh_k, bw_k = _kernel_extents(plan, my, mx)
    compute_dtype = "float32" if precision in _F32_CLASS else "bfloat16"
    n_off = len(offsets) if offsets else 1
    n_ox = len({o[1] for o in offsets}) if offsets else 1
    Pt = -(-(plan.tr * plan.tc) // 128) * 128
    if _route_group(C, Pt, bh_k, bw_k, B, compute_dtype, n_off, n_ox) == 0:
        return None
    return plan


def _offset_margins(offsets):
    if not offsets:
        return 0, 0
    return max(abs(o[0]) for o in offsets), max(abs(o[1]) for o in offsets)


def _kernel_extents(plan: WindowPlan, my: int, mx: int):
    """The fused route's window extents (window_sampler.py:933-935): rows
    to a multiple of 8, columns to a multiple of 128 (with 127 columns of
    slack where tile columns are unaligned), both widened by the offset
    margins. The slack lies inside the window, so it decides values."""
    xq = 0 if plan.ntx <= 1 else plan.tc % 128
    bh_k = -(-(plan.bh + 2 * my) // 8) * 8
    bw_k = -(-(plan.bw + 2 * mx + (127 if xq else 0)) // 128) * 128
    return bh_k, bw_k


def _tile_coords(v, p: WindowPlan):
    """(..., Ho, Wo) -> (T, ..., tr * tc) grouped by tile, edge-padded."""
    lead = v.shape[:-2]
    flat = v.reshape((-1, 1, p.Ho, p.Wo)).float()
    flat = F.pad(flat, (0, p.ntx * p.tc - p.Wo, 0, p.nty * p.tr - p.Ho),
                 mode="replicate")
    n = flat.shape[0]
    flat = flat.reshape(n, p.nty, p.tr, p.ntx, p.tc).permute(1, 3, 0, 2, 4)
    return flat.reshape((p.nty * p.ntx,) + lead + (p.tr * p.tc,))


def _tile_origins(nty: int, ntx: int, tr: int, tc: int, tight: bool) -> np.ndarray:
    """The fused route's per-tile window origins, int32 (2, T): rows
    ``ty * tr``, columns ``tx * tc``, floored to a multiple of 128 unless
    ``tight``. Uploaded once per device through ``resize.on_device``: work
    captured into a CUDA graph may not copy from pageable host memory."""
    tiles = np.arange(nty * ntx)
    sx = (tiles % ntx) * tc
    return np.stack([(tiles // ntx) * tr, sx if tight else sx // 128 * 128]).astype(np.int32)


def make_window_sampler(
    img, out_hw, halo_y: int, halo_x: int,
    interpolation: str = "bilinear", border: str = "clamp",
    tr: int = 8, tc: int = 128, precision: str = "float32",
    xla_plan: WindowPlan | None = None,
    backend: str = "auto", min_out_px: int = 16384,
    offsets: tuple | None = None, site: str = "",
):
    """Reusable sampler fn(x, y) over a fixed (B, C, H, W) source, with the
    reference's signature (window_sampler.py:853-1063).

    Coords (E..., B, Ho, Wo) absolute source coordinates (extra leading
    dims = flow candidates sharing the source) -> (E..., B, C, Ho, Wo).
    With ``offsets`` ((oy, ox), ...) the coords are plain (B, Ho, Wo) and
    the result is (O, B, C, Ho, Wo), slot o sampled at (x + ox, y + oy).

    Two routes, chosen by :func:`fused_route_plan` from the shapes alone:

    - the fused route, where the reference on its TPU takes its Pallas
      kernel: static per-tile windows (origins ``ty * tr`` and
      ``floor128(tx * tc)``, or the exact ``tx * tc`` in tight-x mode) of
      the widened kernel extents, sampled by
      :func:`~.fused_window.fused_window_sample_folded` (K2, or K3 with
      offsets: one window per tile, the source padded by the halo plus the
      offset margin, edge-replicated for "clamp");
    - the plain route, the reference's XLA fallback: ``xla_plan`` (or the
      plan with halos widened by the offset margins), offsets evaluated as
      folded candidate coordinates.

    ``backend``: "auto" takes the fused route where the predicate admits
    it, on CPU (the twin) and CUDA (the kernel) alike; "xla" forces the
    plain route; "kernel" (the reference's "pallas") takes the fused route
    at any output size. ``precision`` enters only the predicate (the
    reference's bf16 step model); the port samples in float32 on both
    routes. The reference's ``xla_tile_chunk`` only bounded its XLA
    memory and is not taken. ``site`` labels the kernel's launches. The
    returned fn's ``backend`` is "kernel" or "xla"."""
    B, C, H, W = img.shape
    Ho, Wo = out_hw
    my, mx = _offset_margins(offsets)
    plan = fused_route_plan(
        B, C, (H, W), (Ho, Wo), halo_y, halo_x, interpolation, border, tr,
        tc, precision, backend, min_out_px, offsets,
    )
    if plan is None:
        if xla_plan is None:
            xla_plan = plan_windows(
                (H, W), (Ho, Wo), halo_y + my, halo_x + mx, interpolation,
                border, tr, tc,
            )

        if offsets is not None:
            off = device_constant(tuple(map(tuple, offsets)), img.device)
            off = off[:, :, None, None, None]  # (O, 2, 1, 1, 1): oy, ox

        def fn_plain(x, y):
            if offsets is not None:
                x, y = x[None] + off[:, 1], y[None] + off[:, 0]
            return _sample_static(img, xla_plan, x, y)

        fn_plain.backend = "xla"
        return fn_plain

    p = plan
    bh_k, bw_k = _kernel_extents(p, my, mx)
    pad_y_t, pad_x_t = p.pad_y + my, p.pad_x + mx
    T = p.nty * p.ntx
    # tile columns off the 128 grid take exact x origins (tight-x mode)
    tight = offsets is None and p.ntx > 1 and p.tc % 128 != 0
    pady2 = max(0, (p.nty - 1) * p.tr + bh_k - (H + pad_y_t))
    padx2 = max(0, (p.ntx - 1) * p.tc // 128 * 128 + bw_k - (W + pad_x_t))
    # offsets read the margin around the base window: edge-replicate for
    # "clamp" (tap-clamp semantics), zeros otherwise
    mode = "replicate" if (offsets and border == "clamp") else "constant"
    padded = F.pad(img.float(), (pad_x_t, padx2, pad_y_t, pady2), mode=mode)
    sy, sx = on_device(_tile_origins, img.device, p.nty, p.ntx, p.tr, p.tc, tight)
    Pt = p.tr * p.tc
    O = 1 if offsets is None else len(offsets)

    def fn(x, y):
        extra = tuple(x.shape[: x.ndim - 3])
        if offsets is not None and extra:
            raise ValueError("offsets mode takes plain (B, Ho, Wo) coords")
        E = int(np.prod(extra, dtype=np.int64)) if extra else 1

        def tiled(v):  # -> (T, B, E * Pt), candidates major within a lead
            v = _tile_coords(v.reshape((E, B, Ho, Wo)), p)  # (T, E, B, Pt)
            return v.permute(0, 2, 1, 3).reshape(T, B, E * Pt)

        out = fused_window_sample_folded(
            padded, sy, sx,
            (tiled(x) + float(pad_x_t)).contiguous(),
            (tiled(y) + float(pad_y_t)).contiguous(),
            bh=bh_k, bw=bw_k, pad_y=pad_y_t, pad_x=pad_x_t, n_y=H, n_x=W,
            interpolation=interpolation, border=border, offsets=offsets,
            base_bw=p.bw if tight else None, off_my=my, off_mx=mx, site=site,
        )  # (T, B, C, E * Pt) or (T, B, O, C, Pt)
        out = out.reshape(p.nty, p.ntx, B, O * C, E, p.tr, p.tc)
        out = out.permute(4, 2, 3, 0, 5, 1, 6)
        out = out.reshape(E, B, O * C, p.nty * p.tr, p.ntx * p.tc)
        out = out[..., :Ho, :Wo]
        if offsets is None:
            return out.reshape(extra + (B, C, Ho, Wo))
        return out.reshape(B, O, C, Ho, Wo).transpose(0, 1)

    fn.backend = "kernel"
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

    xt = _tile_coords(x.reshape(L, p.Ho, p.Wo), p)  # (T, L, tr * tc)
    yt = _tile_coords(y.reshape(L, p.Ho, p.Wo), p)

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
    return _untile(out, p, lead)
