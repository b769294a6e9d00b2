"""Image remap: dense gather remap, and static-warp remaps on the kernel.

Port of ``surround360_tpu/ops/remap.py`` (the cv::remap workhorse of the
reference: ImageWarper.cpp:95-174, NovelView.cpp:174-224). Conventions
as in the reference (OpenCV's):

- images are channels-first ``(..., C, H, W)`` float32;
- ``coords`` is ``(..., 2, Ho, Wo)`` with coords[0] = x (column), coords[1]
  = y (row), in source pixels where integer i samples pixel i exactly;
- bicubic is Keys' kernel with a = -0.75 (OpenCV INTER_CUBIC);
- borders: "constant" (out-of-range taps read 0), "clamp" (edge
  replication) and "wrap" (periodic in x, clamped in y).

Static warps (rig-fixed lens warps: side projection and fisheye strips)
go through :func:`remap_static_banded_multi`: host-planned per-tile
windows and the fused window kernel (``ops/fused_window.py``) — the
reference's TPU route (``_remap_static_pallas``). Because every planned
window covers all of its tile's taps inside the source, the result equals
the dense constant-border remap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .taps import fused_window_sample

__all__ = [
    "remap",
    "remap_bilinear",
    "remap_bicubic",
    "plan_static_remap",
    "remap_static_planned",
    "remap_static_banded",
    "remap_static_banded_multi",
]


def _cubic_weights(t, a=-0.75):
    """Weights of the taps at offsets (-1, 0, 1, 2) for fraction t."""

    def k01(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def k12(s):
        return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

    return k12(t + 1.0), k01(t), k01(1.0 - t), k12(2.0 - t)


def remap(
    img: torch.Tensor,
    coords: torch.Tensor,
    interpolation: str = "bicubic",
    border: str = "constant",
) -> torch.Tensor:
    """Resample ``img`` (..., C, H, W) at ``coords`` (..., 2, Ho, Wo);
    leading batch dims broadcast. Returns (..., C, Ho, Wo)."""
    C, H, W = img.shape[-3:]
    Ho, Wo = coords.shape[-2:]
    batch = torch.broadcast_shapes(img.shape[:-3], coords.shape[:-3])
    img_b = img.expand(batch + (C, H, W)).reshape(-1, C, H * W)
    co = coords.expand(batch + (2, Ho, Wo)).reshape(-1, 2, Ho * Wo)
    x, y = co[:, 0], co[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx, ty = x - x0, y - y0
    # bound before the integer cast so non-finite coords stay defined
    lim = float(2**24)
    ix0 = torch.nan_to_num(x0).clamp(-lim, lim).to(torch.int64)
    iy0 = torch.nan_to_num(y0).clamp(-lim, lim).to(torch.int64)
    if interpolation == "bilinear":
        wx = (1.0 - tx, tx)
        wy = (1.0 - ty, ty)
        offs = (0, 1)
    elif interpolation == "bicubic":
        wx = _cubic_weights(tx)
        wy = _cubic_weights(ty)
        offs = (-1, 0, 1, 2)
    else:
        raise ValueError(f"unknown interpolation: {interpolation}")
    out = torch.zeros(img_b.shape[:2] + (Ho * Wo,), dtype=torch.float32, device=img.device)
    for dy, wyk in zip(offs, wy):
        iy = iy0 + dy
        for dx, wxk in zip(offs, wx):
            ix = ix0 + dx
            w = wxk * wyk
            if border == "constant":
                valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                w = torch.where(valid, w, 0.0)
                ixc, iyc = ix.clamp(0, W - 1), iy.clamp(0, H - 1)
            elif border == "wrap":
                ixc, iyc = torch.remainder(ix, W), iy.clamp(0, H - 1)
            elif border == "clamp":
                ixc, iyc = ix.clamp(0, W - 1), iy.clamp(0, H - 1)
            else:
                raise ValueError(f"unsupported border: {border}")
            idx = (iyc * W + ixc)[:, None, :].expand(-1, C, -1)
            out += w[:, None, :] * torch.gather(img_b, 2, idx)
    return out.reshape(batch + (C, Ho, Wo))


def remap_bilinear(img: torch.Tensor, coords: torch.Tensor, border: str = "constant"):
    return remap(img, coords, interpolation="bilinear", border=border)


def remap_bicubic(img: torch.Tensor, coords: torch.Tensor, border: str = "constant"):
    return remap(img, coords, interpolation="bicubic", border=border)


def _plan_static_tiles(coords_np, H, W, tr, tc, pad_taps):
    """Host: per-(tile, warp) window origins and the uniform window size.
    coords_np (N, 2, Ho, Wo). Returns (sy (T, N), sx (T, N), bh, bw_t, nty,
    ntx): y origins aligned down to 8 rows (the reference's planned
    windows), x origins unaligned with the exact max span bw_t, and bh the
    largest tile's row extent, so every tile's sampled span is covered."""
    N, _, Ho, Wo = coords_np.shape
    nty, ntx = -(-Ho // tr), -(-Wo // tc)
    pr, pc = nty * tr - Ho, ntx * tc - Wo
    v = np.pad(coords_np, [(0, 0), (0, 0), (0, pr), (0, pc)], mode="edge")
    v = v.reshape(N, 2, nty, tr, ntx, tc)

    def axis(vals, n, align):
        valid = (
            np.isfinite(vals)
            & (vals > -(pad_taps + 1))
            & (vals < n + pad_taps + 1)
        )
        vmin = np.where(valid, vals, np.inf).min(axis=(2, 4))
        vmax = np.where(valid, vals, -np.inf).max(axis=(2, 4))
        none = ~valid.any(axis=(2, 4))
        vmin = np.where(none, 0.0, vmin)
        vmax = np.where(none, 0.0, vmax)
        lo = np.clip(np.floor(vmin) - pad_taps, 0, max(n - 1, 0))
        hi = np.clip(np.ceil(vmax) + pad_taps + 1, 1, n)
        lo_a = (lo.astype(np.int64) // align) * align
        b = int(np.max(hi - lo_a))
        b = -(-b // align) * align
        return lo_a.astype(np.int32), b

    sy, bh = axis(v[:, 1], H, 8)  # (N, nty, ntx)
    sx, bw_t = axis(v[:, 0], W, 1)
    sy = sy.reshape(N, -1).T.copy()  # (T, N)
    sx = sx.reshape(N, -1).T.copy()
    return sy, sx, bh, bw_t, nty, ntx


@dataclass
class StaticRemapPlan:
    """Host-planned windows plus tiled device coords of a static warp."""

    sy: torch.Tensor  # (T, N) int32
    sx: torch.Tensor  # (T, N) int32
    xt: torch.Tensor  # (T, N, P) float32
    yt: torch.Tensor  # (T, N, P) float32
    bh: int
    bw: int
    H: int
    W: int
    Ho: int
    Wo: int
    tr: int
    tc: int
    nty: int
    ntx: int
    interpolation: str


def plan_static_remap(
    coords_np: np.ndarray,
    H: int,
    W: int,
    interpolation: str,
    device,
    tr: int = 16,
    tc: int = 128,
) -> StaticRemapPlan:
    """Plan N static warps (N, 2, Ho, Wo) over (H, W) sources for the
    fused kernel: (tr, tc) output tiles, one window per (tile, warp)."""
    coords_np = np.asarray(coords_np, np.float32)
    N, _, Ho, Wo = coords_np.shape
    pad_taps = 3 if interpolation == "bicubic" else 1
    sy, sx, bh, bw_t, nty, ntx = _plan_static_tiles(
        coords_np, H, W, tr, tc, pad_taps
    )
    co = torch.from_numpy(coords_np).to(device)
    co = F.pad(co, (0, ntx * tc - Wo, 0, nty * tr - Ho), mode="replicate")
    co = co.reshape(N, 2, nty, tr, ntx, tc).permute(2, 4, 0, 1, 3, 5)
    co = co.reshape(nty * ntx, N, 2, tr * tc)
    return StaticRemapPlan(
        sy=torch.from_numpy(sy).to(device),
        sx=torch.from_numpy(sx).to(device),
        xt=co[:, :, 0].contiguous(),
        yt=co[:, :, 1].contiguous(),
        bh=int(bh), bw=int(bw_t), H=H, W=W, Ho=Ho, Wo=Wo, tr=tr, tc=tc,
        nty=nty, ntx=ntx, interpolation=interpolation,
    )


def remap_static_planned(
    imgs: torch.Tensor, plan: StaticRemapPlan, site: str = ""
) -> torch.Tensor:
    """Apply a static plan: imgs (N, C, H, W) -> (N, C, Ho, Wo), constant
    border, through the fused window kernel (its twin on the CPU)."""
    N, C, H, W = imgs.shape
    if (H, W) != (plan.H, plan.W) or N != plan.sy.shape[1]:
        raise ValueError("images do not match the static remap plan")
    out = fused_window_sample(
        imgs.float().contiguous(), plan.sy, plan.sx, plan.xt, plan.yt,
        bh=plan.bh, bw=plan.bw, pad_y=0, pad_x=0, n_y=H, n_x=W,
        interpolation=plan.interpolation, border="constant", site=site,
    )  # (T, N, C, P)
    out = out.reshape(plan.nty, plan.ntx, N, C, plan.tr, plan.tc)
    out = out.permute(2, 3, 0, 4, 1, 5).reshape(
        N, C, plan.nty * plan.tr, plan.ntx * plan.tc
    )
    return out[..., : plan.Ho, : plan.Wo]


def remap_static_banded_multi(
    imgs: torch.Tensor,
    coords_np: np.ndarray,
    interpolation: str = "bicubic",
    border: str = "constant",
    site: str = "",
) -> torch.Tensor:
    """Remap N images through N static host warps. imgs (N, ..., C, H, W)
    (extra dims fold into the channels, sharing warp n); coords_np host
    numpy (N, 2, Ho, Wo). Returns (N, ..., C, Ho, Wo)."""
    if border != "constant":
        raise ValueError("the static remap supports the constant border only")
    coords_np = np.asarray(coords_np)
    N = coords_np.shape[0]
    H, W = imgs.shape[-2:]
    if imgs.shape[0] != N:
        raise ValueError(f"{tuple(imgs.shape)} vs {coords_np.shape}")
    lead = imgs.shape[1:-2]
    plan = plan_static_remap(coords_np, H, W, interpolation, imgs.device)
    out = remap_static_planned(imgs.reshape(N, -1, H, W), plan, site=site)
    return out.reshape((N,) + lead + out.shape[-2:])


def remap_static_banded(
    img: torch.Tensor,
    coords_np: np.ndarray,
    interpolation: str = "bicubic",
    border: str = "constant",
    site: str = "",
) -> torch.Tensor:
    """Single-warp form: img (..., C, H, W) sharing ONE warp (2, Ho, Wo)."""
    out = remap_static_banded_multi(
        img[None], np.asarray(coords_np)[None], interpolation, border, site
    )
    return out[0]
