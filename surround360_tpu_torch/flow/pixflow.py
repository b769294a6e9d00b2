"""Pyramidal patch-match optical flow, ``pixflow_tpu`` preset.

Port of ``surround360_tpu/flow/pixflow.py`` for the preset the renderer's
main path uses (``make_flow_params("pixflow_tpu")``). The reference
rebuilds PixFlow (surround360_render/source/optical_flow/PixFlow.h) with a
data-parallel inner loop: per pyramid level, two sweeps of jump-flooding
propagation rounds (offsets d from ``prop_offsets``; neighbour-shifted and
+-d probe candidates ranked by the PixFlow energy, then one numeric-
gradient descent step), a 5x5 separable median after each sweep,
low-alpha diffusion, and the temporal prior toward the previous frame.

The I1 gradient image is sampled through static windows
(``ops.window_sampler.make_window_sampler``, plain torch) with the
reference's budgeted plan, so beyond-halo candidates read zero samples
exactly as in the reference. Everything is batched over (B, ...) and runs
eagerly; ``lax.scan`` over the rounds is a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.filters import median_filter_5x5_separable
from ..ops.resize import gaussian_blur, resize_bilinear, resize_cubic
from ..ops.window_sampler import make_window_sampler, plan_windows_budgeted

HINT_UNKNOWN = 0
HINT_LEFT = 1
HINT_RIGHT = 2
HINT_DOWN = 3
HINT_UP = 4

# constants mirrored from PixFlow.h:37-49
GRAD_EPSILON = 0.001
UPDATE_ALPHA_THRESHOLD = 0.9
PRE_BLUR_KSIZE = 5
PRE_BLUR_SIGMA = 0.25
FINAL_FLOW_BLUR_KSIZE = 3
FINAL_FLOW_BLUR_SIGMA = 1.0
GRADIENT_BLUR_KSIZE = 3
GRADIENT_BLUR_SIGMA = 0.5
BLURRED_FLOW_KSIZE = 15
BLURRED_FLOW_SIGMA = 8.0

# the reference's window-stack budget for the flow samplers: it decides
# the tile geometry (and so the windows) at large pyramid levels
WINDOW_STACK_MAX_ELEMS = 256 * 1024 * 1024

_NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0))
_PROBES = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


class FlowParams(NamedTuple):
    """The ``pixflow_tpu`` hyperparameters (OpticalFlowFactory.h:25-61
    plus the reference's propagation schedule and sampler halos)."""

    pyr_scale_factor: float = 0.5
    smoothness_coef: float = 0.001
    vertical_regularization_coef: float = 0.01
    horizontal_regularization_coef: float = 0.01
    gradient_step_size: float = 0.5
    downscale_factor: float = 0.5
    prop_offsets: tuple = (8, 4, 2, 1)
    fine_prop_offsets: tuple = (2, 1)
    use_probe_candidates: bool = True
    min_image_size: int = 12
    window_halo_x_frac: float = 0.25
    window_halo_y_frac: float = 0.12
    window_min_halo: int = 6
    window_tile_cols: int = 16


def make_flow_params(name: str) -> FlowParams:
    """Name -> params. Only the renderer's ``pixflow_tpu`` preset is
    ported; the other presets of the reference are not (yet)."""
    if name == "pixflow_tpu":
        return FlowParams()
    raise ValueError(f"flow algorithm not ported: {name}")


def _sobel_k1(img: torch.Tensor, axis: int) -> torch.Tensor:
    """[-1, 0, 1] derivative with replicated border (PixFlow.h:356-359)."""
    n = img.shape[axis]
    nxt = torch.cat([img.narrow(axis, 1, n - 1), img.narrow(axis, n - 1, 1)], axis)
    prv = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)], axis)
    return nxt - prv


def _shift(arr: torch.Tensor, dy: int, dx: int, fallback: torch.Tensor):
    """Content shifted by (dy, dx); positions whose source falls outside
    the frame take ``fallback`` (out-of-range proposals become no-ops)."""
    H, W = arr.shape[-2:]
    rolled = torch.roll(arr, (dy, dx), dims=(-2, -1))
    ys = torch.arange(H, device=arr.device)
    xs = torch.arange(W, device=arr.device)
    yv = (ys - dy >= 0) & (ys - dy < H)
    xv = (xs - dx >= 0) & (xs - dx < W)
    return torch.where(yv[:, None] & xv[None, :], rolled, fallback)


def _error_from_samples(flow, g, I0x, I0y, blurred_flow, params: FlowParams):
    """PixFlow energy (PixFlow.h:493-534) for candidate ``flow``
    (..., 2, H, W) given sampled I1 gradients ``g`` (..., 2, H, W)."""
    H, W = I0x.shape[-2:]
    data = torch.sqrt((I0x - g[..., 0, :, :]) ** 2 + (I0y - g[..., 1, :, :]) ** 2)
    fdiff = blurred_flow - flow
    smooth = torch.sqrt(fdiff[..., 0, :, :] ** 2 + fdiff[..., 1, :, :] ** 2)
    return (
        data
        + smooth * params.smoothness_coef
        + params.vertical_regularization_coef * torch.abs(flow[..., 1, :, :]) / W
        + params.horizontal_regularization_coef * torch.abs(flow[..., 0, :, :]) / H
    )


def _propagation_and_search(
    I0, I1, alpha0, alpha1, flow, params: FlowParams, is_finest: bool
):
    """One pyramid level. I0/I1/alpha0/alpha1 (B, H, W); flow (B, 2, H, W)."""
    B, H, W = I0.shape
    offsets = (
        params.fine_prop_offsets
        if (is_finest and params.fine_prop_offsets)
        else params.prop_offsets
    )
    blur = lambda a: gaussian_blur(a, GRADIENT_BLUR_SIGMA, ksize=GRADIENT_BLUR_KSIZE)
    I0x, I0y = blur(_sobel_k1(I0, -1)), blur(_sobel_k1(I0, -2))
    I1g = torch.stack([blur(_sobel_k1(I1, -1)), blur(_sobel_k1(I1, -2))], dim=-3)

    dev = I0.device
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    gate = (alpha0 > UPDATE_ALPHA_THRESHOLD) & (alpha1 > UPDATE_ALPHA_THRESHOLD)

    halo_x = max(params.window_min_halo, int(params.window_halo_x_frac * W))
    halo_y = max(params.window_min_halo, int(params.window_halo_y_frac * H))
    plan = plan_windows_budgeted(
        (H, W), (H, W), halo_y, halo_x, "bilinear", "clamp",
        tr=8, tc=params.window_tile_cols,
        elems_per_px=int(np.prod(I1g.shape[:-2])),
        max_window_elems=WINDOW_STACK_MAX_ELEMS,
    )
    sample_fn = make_window_sampler(I1g, plan)

    def error_field(cand, blurred_flow):
        # bilinear-extend sampling: coords clipped to [0, n-2]
        mx = torch.clamp(gx + cand[..., 0, :, :], 0.0, W - 2.0)
        my = torch.clamp(gy + cand[..., 1, :, :], 0.0, H - 2.0)
        return _error_from_samples(
            cand, sample_fn(mx, my), I0x, I0y, blurred_flow, params
        )

    def round_d(flow, d, blurred_flow):
        cands = [flow] + [_shift(flow, dy * d, dx * d, flow) for dy, dx in _NEIGHBOURS]
        if params.use_probe_candidates:
            for py, px in _PROBES:
                delta = torch.tensor([px * d, py * d], dtype=torch.float32, device=dev)
                cands.append(flow + delta[:, None, None])
        cand = torch.stack(cands, dim=0)  # (K, B, 2, H, W)
        errs = error_field(cand, blurred_flow)  # (K, B, H, W)
        curr_err, best = torch.min(errs, dim=0)
        idx = best[None, :, None].expand(1, B, 2, H, W)
        flow_prop = torch.gather(cand, 0, idx)[0]
        eps = torch.tensor([GRAD_EPSILON, 0.0], device=dev)[:, None, None]
        e2 = error_field(
            torch.stack([flow_prop + eps, flow_prop + eps.flip(0)]), blurred_flow
        )
        gflow = torch.stack([e2[0] - curr_err, e2[1] - curr_err], dim=-3) / GRAD_EPSILON
        flow_new = flow_prop - params.gradient_step_size * gflow
        return torch.where(gate[:, None], flow_new, flow)

    def sweep(flow):
        blurred_flow = gaussian_blur(flow, BLURRED_FLOW_SIGMA, ksize=BLURRED_FLOW_KSIZE)
        for d in offsets:
            flow = round_d(flow, int(d), blurred_flow)
        return flow

    # two sweeps with a 5x5 median between and after (PixFlow.h:388-411)
    flow = median_filter_5x5_separable(sweep(flow))
    flow = median_filter_5x5_separable(sweep(flow))

    # low-alpha diffusion toward the blurred flow (PixFlow.h:437-454)
    blurred_flow = gaussian_blur(flow, BLURRED_FLOW_SIGMA, ksize=BLURRED_FLOW_KSIZE)
    diffusion = (1.0 - alpha0 * alpha1)[:, None]
    return diffusion * blurred_flow + (1.0 - diffusion) * flow


def _pyramid_sizes(h: int, w: int, params: FlowParams):
    """Level sizes, finest first (buildPyramid, PixFlow.h:477-491)."""
    sizes = [(h, w)]
    while True:
        nh = int(sizes[-1][0] * params.pyr_scale_factor + 0.5)
        nw = int(sizes[-1][1] * params.pyr_scale_factor + 0.5)
        if nh <= params.min_image_size or nw <= params.min_image_size:
            break
        sizes.append((nh, nw))
    return sizes


def _to_grey_alpha(rgba: torch.Tensor):
    """(B, 4, H, W) RGBA -> grey, alpha (B, H, W) (BT.601 weights)."""
    r, g, b, a = rgba[:, 0], rgba[:, 1], rgba[:, 2], rgba[:, 3]
    return 0.299 * r + 0.587 * g + 0.114 * b, a


def compute_flow(
    img0: torch.Tensor,
    img1: torch.Tensor,
    params: FlowParams,
    hint=None,
    prev_flow=None,
    prev_img0=None,
    prev_img1=None,
    use_temporal: bool = False,
) -> torch.Tensor:
    """Optical flow img0 -> img1 (computeOpticalFlow, PixFlow.h:81-183).

    img0/img1 (B, 4, H, W) RGBA float32 in [0,1]; prev_*: the previous
    frame's flow (B, 2, h, w) and images, used when ``use_temporal``.
    ``hint`` (direction hints) is accepted for the reference's interface;
    the pixflow_tpu preset runs no hinted search. Returns (B, 2, H, W)
    pixels at input resolution."""
    del hint, prev_img0  # unused by this preset, as in the reference
    B, C, H, W = img0.shape
    if C != 4:
        raise ValueError("expected RGBA input")
    dev = img0.device
    dh, dw = int(H * params.downscale_factor), int(W * params.downscale_factor)
    img0d = resize_cubic(img0, (dh, dw))
    img1d = resize_cubic(img1, (dh, dw))

    if use_temporal:
        prev_flow_d = resize_cubic(prev_flow, (dh, dw)) * (dh / prev_flow.shape[-2])
        prev1d = resize_cubic(prev_img1, (dh, dw))
        motion = torch.sum(torch.abs(img1d[:, :3] - prev1d[:, :3]), dim=1) / 3.0

    I0, alpha0 = _to_grey_alpha(img0d)
    I1, alpha1 = _to_grey_alpha(img1d)
    I0 = gaussian_blur(I0, PRE_BLUR_SIGMA, ksize=PRE_BLUR_KSIZE)
    I1 = gaussian_blur(I1, PRE_BLUR_SIGMA, ksize=PRE_BLUR_KSIZE)

    sizes = _pyramid_sizes(dh, dw, params)
    flow = None
    for level in range(len(sizes) - 1, -1, -1):
        lh, lw = sizes[level]
        I0l = resize_bilinear(I0, (lh, lw)) if level else I0
        I1l = resize_bilinear(I1, (lh, lw)) if level else I1
        a0l = resize_bilinear(alpha0, (lh, lw)) if level else alpha0
        a1l = resize_bilinear(alpha1, (lh, lw)) if level else alpha1
        if flow is None:
            flow = torch.zeros((B, 2, lh, lw), dtype=torch.float32, device=dev)
        flow = _propagation_and_search(
            I0l, I1l, a0l, a1l, flow, params, is_finest=(level == 0)
        )
        if use_temporal:
            # adjustFlowTowardPrevious (PixFlow.h:185-193)
            prev_l = resize_cubic(prev_flow_d, (lh, lw)) * (lh / dh)
            w = (1.0 - resize_bilinear(motion, (lh, lw)))[:, None]
            flow = flow * (1.0 - w) + prev_l * w
        if level > 0:
            nh, nw = sizes[level - 1]
            flow = resize_cubic(flow, (nh, nw)) * (1.0 / params.pyr_scale_factor)

    flow = resize_bilinear(flow, (H, W)) * (1.0 / params.downscale_factor)
    return gaussian_blur(flow, FINAL_FLOW_BLUR_SIGMA, ksize=FINAL_FLOW_BLUR_KSIZE)
