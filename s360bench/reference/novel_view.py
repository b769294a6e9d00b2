"""Flow-based novel-view synthesis for the ring of side cameras.

Port of the renderer's half of ``surround360_tpu/views/novel_view.py``
(reference: surround360_render/source/optical_flow/NovelView.{h,cpp}).
The reference's lazy novel-view buffer is, per chunk column, an affine
sample column plus a time shift t (TestRenderStereoPanorama.cpp:259-292),
so one lazy render is: a 1-D bicubic column resample of the flow, a 2-D
bicubic sample of the source at (warp_x + t * flow_x, y + t * flow_y)
(NovelView.cpp:174-224), and the deghost blend of the from-L and from-R
renders (combineLazyViews, NovelView.cpp:101-154). Batched over pairs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .pixflow import HINT_LEFT, HINT_RIGHT, compute_flow
from .remap import remap
from .resize import matmul_batched, on_device
from .window_sampler import sample_displaced, sample_displaced_residual

__all__ = [
    "lazy_warp_columns",
    "render_lazy_novel_view",
    "combine_lazy_views",
    "render_chunk_pair",
    "prepare_pair_flows",
    "generate_novel_view",
    "combine_novel_views",
]

# Halo sizes above which the lazy render samples through displacement-
# following residual windows (the fused window kernel); below them, static
# windows. The reference's thresholds, so both take the same route.
RESIDUAL_MIN_HALO_Y = 64
RESIDUAL_MIN_HALO_X = 96

# residual-window tiling and halos of the lazy render (reference defaults)
NOVEL_RESIDUAL_TR = 8
NOVEL_RESIDUAL_TC = 64
NOVEL_RESIDUAL_RHY = 24
NOVEL_RESIDUAL_RHX = 40


def lazy_warp_columns(
    chunk_width: int, cam_image_width: int, verge_displacement: float, eye: str
) -> tuple[np.ndarray, np.ndarray]:
    """Per-column (sample_x, t) for one eye's chunk
    (TestRenderStereoPanorama.cpp:271-285)."""
    nv = np.arange(chunk_width, dtype=np.float64)
    shift = nv / chunk_width
    slab = cam_image_width * 0.5 - (chunk_width - nv)
    sign = 1.0 if eye == "left" else -1.0
    warp_x = slab + sign * verge_displacement
    return warp_x.astype(np.float32), shift.astype(np.float32)


@lru_cache(maxsize=64)
def _column_sample_matrix(src_width: int, warp_x_key: tuple) -> np.ndarray:
    """(chunk_w, src_w) bicubic column-sampling matrix with clamped
    borders: sampled[:, c] = sum_w S[c, w] * field[:, w]."""
    a = -0.75
    warp_x = np.asarray(warp_x_key, dtype=np.float64)
    i0 = np.floor(warp_x).astype(np.int64)
    t = warp_x - i0
    m = np.zeros((len(warp_x), src_width), dtype=np.float64)
    rows = np.arange(len(warp_x))

    def k01(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def k12(s):
        return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

    for tap, w in enumerate([k12(t + 1.0), k01(t), k01(1.0 - t), k12(2.0 - t)]):
        j = np.clip(i0 - 1 + tap, 0, src_width - 1)
        np.add.at(m, (rows, j), w)
    return m.astype(np.float32)


def _lazy_warp_compose(flow, warp_x: np.ndarray, t_cols: np.ndarray, invert_t: bool):
    """Flow column resample + warp composition of one lazy render:
    (warp_comp_x, warp_comp_y (B, H, Wc), t (Wc,), flow_mag (B, H, Wc))."""
    B, _, H, W = flow.shape
    dev = flow.device
    S = on_device(_column_sample_matrix, dev, W, tuple(np.round(warp_x, 6)))
    remapped = matmul_batched(None, flow, S.T)  # (B, 2, H, Wc)
    t = torch.from_numpy(1.0 - t_cols if invert_t else t_cols).to(dev)
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    warp_comp_x = torch.from_numpy(warp_x).to(dev)[None, None, :] + remapped[:, 0] * t
    warp_comp_y = gy[None] + remapped[:, 1] * t
    flow_mag = torch.sqrt(remapped[:, 0] ** 2 + remapped[:, 1] ** 2)
    return warp_comp_x, warp_comp_y, t, flow_mag


def _sample_lazy(srcs, xs, ys, rebase_x: int = 0):
    """Sample sliced sources (..., 4, H, Ws) at (..., H, Wc): residual
    windows (the fused kernel) above the halo thresholds, else static.

    rebase_x: constant x offset that some leads carry on top of their
    displacement because they share a slice cut for the others; it rides
    on the global x bound (the route is decided without it)."""
    H, src_w = srcs.shape[-2:]
    halo_x = max(8, int(0.20 * src_w))
    halo_y = max(8, int(0.10 * H))
    residual = halo_y > RESIDUAL_MIN_HALO_Y or halo_x > RESIDUAL_MIN_HALO_X
    halo_x += rebase_x
    if residual:
        return sample_displaced_residual(
            srcs, xs, ys,
            halo_y=halo_y, halo_x=halo_x,
            res_halo_y=min(halo_y, NOVEL_RESIDUAL_RHY),
            res_halo_x=min(halo_x, NOVEL_RESIDUAL_RHX),
            interpolation="bicubic", border="constant",
            tr=NOVEL_RESIDUAL_TR, tc=NOVEL_RESIDUAL_TC, site="novel_view",
        )
    return sample_displaced(
        srcs, xs, ys, halo_y=halo_y, halo_x=halo_x,
        interpolation="bicubic", border="constant", tr=8, tc=128,
        max_window_elems=64 * 1024 * 1024,
    )


def render_lazy_novel_view(src, flow, warp_x: np.ndarray, t_cols: np.ndarray, invert_t: bool):
    """One of the four per-pair lazy renders (NovelView.cpp:174-224).
    src (B, 4, H, W); flow (B, 2, H, W). Returns (novel (B, 4, H, Wc),
    flow_mag (B, H, Wc))."""
    W = src.shape[-1]
    Wc = len(warp_x)
    wcx, wcy, t, flow_mag = _lazy_warp_compose(flow, warp_x, t_cols, invert_t)
    # slice at floor(delta) - 3 (bicubic taps reach 2 px left of a sample)
    delta_i = int(np.floor(warp_x[0])) - 3
    if 0 < delta_i < W - Wc:
        novel = _sample_lazy(src[..., delta_i:], wcx - delta_i, wcy)
    else:
        novel = remap(src, torch.stack([wcx, wcy], dim=1), "bicubic", "constant")
    alpha = novel[:, 3] * (1.0 - t)[None, None, :]
    return torch.cat([novel[:, :3], alpha[:, None]], dim=1), flow_mag


def combine_lazy_views(novel_l, novel_r, mag_l, mag_r):
    """Blend the from-L and from-R renders (combineLazyViews,
    NovelView.cpp:101-154). (B, 4, H, Wc) / (B, H, Wc) -> (B, 4, H, Wc)."""
    k_color_diff_coef = 10.0
    k_sharpness = 10.0
    k_flow_mag_coef = 20.0

    W_img = novel_l.shape[-1]
    a_l = novel_l[:, 3]
    a_r = novel_r[:, 3]
    out_alpha = (torch.maximum(a_l, a_r) > 0.1).to(novel_l.dtype)

    norm = a_l + a_r
    safe_norm = torch.where(norm == 0, 1.0, norm)
    blend_l = a_l / safe_norm
    blend_r = a_r / safe_norm

    color_diff = torch.sum(torch.abs(novel_l[:, :3] - novel_r[:, :3]), dim=1)
    deghost = torch.tanh(color_diff * k_color_diff_coef)
    exp_l = torch.exp(k_sharpness * blend_l * (1.0 + k_flow_mag_coef * (mag_l / W_img)))
    exp_r = torch.exp(k_sharpness * blend_r * (1.0 + k_flow_mag_coef * (mag_r / W_img)))
    sum_exp = exp_l + exp_r + 1e-5
    w_l = blend_l + deghost * (exp_l / sum_exp - blend_l)
    w_r = blend_r + deghost * (exp_r / sum_exp - blend_r)

    both = (a_l > 0) & (a_r > 0)
    only_l = (a_l > 0) & ~both
    only_r = (a_r > 0) & ~both
    rgb_blend = novel_l[:, :3] * w_l[:, None] + novel_r[:, :3] * w_r[:, None]
    zero = torch.zeros_like(rgb_blend)
    rgb = torch.where(
        both[:, None], rgb_blend,
        torch.where(only_l[:, None], novel_l[:, :3],
                    torch.where(only_r[:, None], novel_r[:, :3], zero)),
    )
    return torch.cat([rgb, out_alpha[:, None]], dim=1)


def render_chunk_pair(
    image_l, image_r, flow_l_to_r, flow_r_to_l, warp_x_l, t_cols, warp_x_r
):
    """One camera pair's left/right-eye chunks (combineLazyNovelViews,
    NovelView.cpp:226-268): 4 lazy renders (eye x source) sampled in ONE
    batched call (lead axis = render x pair), then 2 deghost blends.
    Returns (chunk_left_eye, chunk_right_eye), each (B, 4, H, chunk_w)."""
    W = image_l.shape[-1]
    Wc = len(warp_x_l)
    renders = (
        (image_l, flow_r_to_l, warp_x_l, False),
        (image_r, flow_l_to_r, warp_x_l, True),
        (image_l, flow_r_to_l, warp_x_r, False),
        (image_r, flow_l_to_r, warp_x_r, True),
    )
    comps = [_lazy_warp_compose(f, wx, t_cols, inv) for (_, f, wx, inv) in renders]
    delta_i = int(np.floor(min(warp_x_l[0], warp_x_r[0]))) - 3
    if 0 < delta_i < W - Wc:
        srcs = torch.stack([img[..., delta_i:] for (img, *_) in renders])
        xs = torch.stack([c[0] - delta_i for c in comps])  # (4, B, H, Wc)
        ys = torch.stack([c[1] for c in comps])
        # the eye whose columns start further right sits 2 * verge px off
        # the shared slice: widen the x bound by that rebase, or its
        # windows stop following it (the reference's batched call clamps
        # it to the unwidened bound and drops ~1/3 of that eye's taps)
        rebase_x = int(np.floor(max(warp_x_l[0], warp_x_r[0]))) - 3 - delta_i
        novel4 = _sample_lazy(srcs, xs, ys, rebase_x)
        views = []
        for i, c in enumerate(comps):
            alpha = novel4[i, :, 3] * (1.0 - c[2])[None, None, :]
            views.append(torch.cat([novel4[i, :, :3], alpha[:, None]], dim=1))
        mags = [c[3] for c in comps]
    else:
        views, mags = [], []
        for (img, f, wx, inv) in renders:
            v, m = render_lazy_novel_view(img, f, wx, t_cols, inv)
            views.append(v)
            mags.append(m)
    chunk_l = combine_lazy_views(views[0], views[1], mags[0], mags[1])
    chunk_r = combine_lazy_views(views[2], views[3], mags[2], mags[3])
    return chunk_l, chunk_r


def prepare_pair_flows(
    overlap_l, overlap_r, params,
    prev_flow_l_to_r=None, prev_flow_r_to_l=None,
    prev_overlap_l=None, prev_overlap_r=None,
    use_temporal: bool = False, site: str = "",
):
    """Asymmetric pair flows (NovelView.cpp:270-299): L->R with hint LEFT,
    R->L with hint RIGHT, each with its own temporal prior. ``site`` labels
    the flow's kernel launches."""
    B = overlap_l.shape[0]
    dev = overlap_l.device
    flow_l_to_r = compute_flow(
        overlap_l, overlap_r, params,
        hint=torch.full((B,), HINT_LEFT, dtype=torch.int32, device=dev),
        prev_flow=prev_flow_l_to_r, prev_img0=prev_overlap_l,
        prev_img1=prev_overlap_r, use_temporal=use_temporal, site=site,
    )
    flow_r_to_l = compute_flow(
        overlap_r, overlap_l, params,
        hint=torch.full((B,), HINT_RIGHT, dtype=torch.int32, device=dev),
        prev_flow=prev_flow_r_to_l, prev_img0=prev_overlap_r,
        prev_img1=prev_overlap_l, use_temporal=use_temporal, site=site,
    )
    return flow_l_to_r, flow_r_to_l


# the eager novel-view path (NovelView.cpp:27-99; the reference's optical
# flow tests and flow-quality harness use it)


def generate_novel_view(src, reverse_flow, t: float):
    """Shifted view at time t: ``src`` (B, C, H, W) sampled bicubically at
    p + t * reverse_flow, constant border (generateNovelViewSimpleCvRemap,
    NovelView.cpp:27-45)."""
    H, W = src.shape[-2:]
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=src.device),
        torch.arange(W, dtype=torch.float32, device=src.device),
        indexing="ij",
    )
    coords = torch.stack([gx[None] + reverse_flow[:, 0] * t,
                          gy[None] + reverse_flow[:, 1] * t], dim=1)
    return remap(src, coords, interpolation="bicubic", border="constant")


def combine_novel_views(view_l, blend_l, view_r, blend_r, flow_l_to_r, flow_r_to_l):
    """Eager blend of two (B, 4, H, W) views (combineNovelViews,
    NovelView.cpp:47-99): a softmax of the blend weights sharpened by the
    alphas and the flow magnitudes, applied as far as the colours differ
    (the deghost tanh); kColorDiffCoef = 10, kSoftmaxSharpness = 10,
    kFlowMagCoef = 100."""
    k_flow_mag_coef = 100.0
    k_sharpness = 10.0
    k_color_diff_coef = 10.0
    W_img = view_l.shape[-1]
    a_l = view_l[:, 3]
    a_r = view_r[:, 3]
    mag_lr = torch.sqrt(flow_l_to_r[:, 0] ** 2 + flow_l_to_r[:, 1] ** 2) / W_img
    mag_rl = torch.sqrt(flow_r_to_l[:, 0] ** 2 + flow_r_to_l[:, 1] ** 2) / W_img
    color_diff = torch.sum(torch.abs(view_l[:, :3] - view_r[:, :3]), dim=1)
    deghost = torch.tanh(color_diff * k_color_diff_coef)
    exp_l = torch.exp(k_sharpness * blend_l * a_l * (1.0 + k_flow_mag_coef * mag_rl))
    exp_r = torch.exp(k_sharpness * blend_r * a_r * (1.0 + k_flow_mag_coef * mag_lr))
    sum_exp = exp_l + exp_r + 1e-5
    w_l = blend_l + deghost * (exp_l / sum_exp - blend_l)
    w_r = blend_r + deghost * (exp_r / sum_exp - blend_r)
    has_l, has_r = a_l > 0, a_r > 0
    both = (has_l & has_r)[:, None]
    blended = view_l[:, :3] * w_l[:, None] + view_r[:, :3] * w_r[:, None]
    one = torch.where(has_l[:, None], view_l[:, :3],
                      torch.where(has_r[:, None], view_r[:, :3], 0.0))
    rgb = torch.where(both, blended, one)
    alpha = (has_l | has_r).to(view_l.dtype)
    return torch.cat([rgb, alpha[:, None]], dim=1)
