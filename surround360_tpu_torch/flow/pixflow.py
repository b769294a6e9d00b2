"""Pyramidal patch-match optical flow, every preset of the reference.

Port of ``surround360_tpu/flow/pixflow.py``. The reference rebuilds PixFlow
(surround360_render/source/optical_flow/PixFlow.h) with a data-parallel
inner loop: per pyramid level, two sweeps of jump-flooding propagation
rounds (offsets d from ``prop_offsets``; neighbour-shifted and optional
+-d probe candidates ranked by the PixFlow energy, then one numeric-
gradient descent step), a 5x5 median after each sweep, low-alpha
diffusion, the temporal prior toward the previous frame, and, for
``pixflow_search_20``, a direction-hinted brute-force search at the
coarsest level.

The I1 gradient image is sampled through static windows
(``ops.window_sampler.make_window_sampler``) with the reference's plans,
so beyond-halo candidates read zero samples exactly as in the reference.
``pixflow_tpu_offsets`` ranks each round's candidates through one
offset-field sampler call (kernel K3 on its fused route);
``pixflow_tpu_fast`` samples the finest levels at residual displacements
against the I1 gradients warped by the level's incoming flow.

Everything is batched over (B, ...) and runs eagerly; ``lax.scan`` over
the rounds is a Python loop. The port samples in float32 wherever the
reference picks single-pass bf16 on its TPU
(``error_sampler_precision="default"``), so ``pixflow_tpu`` and
``pixflow_tpu_f32`` compute the same thing here.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from functools import lru_cache, partial
from typing import NamedTuple

import numpy as np
import torch

from ..ops.filters import median_filter, median_filter_5x5_separable
from ..ops.resize import (
    device_constant,
    gaussian_blur,
    per_image,
    pinning,
    resize_bilinear,
    resize_cubic,
)
from ..ops.window_sampler import (
    fused_route_plan,
    make_window_sampler,
    plan_windows_budgeted,
)
from ..utils.tracing import count, span

HINT_UNKNOWN = 0
HINT_LEFT = 1
HINT_RIGHT = 2
HINT_DOWN = 3
HINT_UP = 4

# constants mirrored from PixFlow.h:37-49
PYR_MIN_IMAGE_SIZE = 24
GRAD_EPSILON = 0.001
UPDATE_ALPHA_THRESHOLD = 0.9
MEDIAN_BLUR_SIZE = 5
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

# offset-ranking sampler tiles (the reference's S360_FLOW_OFFSET_TR/TC
# defaults): they decide the fused route's windows
_OFFSET_RANK_TR = 8
_OFFSET_RANK_TC = 128

_NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0))
_PROBES = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


class FlowParams(NamedTuple):
    """Hyperparameters (OpticalFlowFactory.h:25-61) plus the reference's
    propagation schedule, sampler halos and ranking options, with its
    defaults (``FlowParams()`` is ``pixflow_low``)."""

    pyr_scale_factor: float = 0.9
    smoothness_coef: float = 0.001
    vertical_regularization_coef: float = 0.01
    horizontal_regularization_coef: float = 0.01
    gradient_step_size: float = 0.5
    downscale_factor: float = 0.5
    directional_regularization_coef: float = 0.0
    use_directional_regularization: bool = False
    search_max_percentage: int = 0  # pixflow_search_20 -> 20
    prop_offsets: tuple = (4, 2, 1)
    # shorter schedule for the finest level; empty = prop_offsets everywhere
    fine_prop_offsets: tuple = ()
    use_probe_candidates: bool = False
    # "nearest" selects the separable 5-median; anything else the full one
    rank_sampler: str = "bilinear"
    min_image_size: int = PYR_MIN_IMAGE_SIZE
    window_halo_x_frac: float = 0.25
    window_halo_y_frac: float = 0.12
    window_min_halo: int = 6
    window_tile_cols: int = 16
    # rank each round's candidates through one offset-field sampler call
    offset_ranking: bool = False
    # sample the error fields at residual displacements where it pays
    residual_rebase: bool = False
    # enters only the sampler's route predicate (see module docstring)
    error_sampler_precision: str = "float32"


def make_flow_params(name: str) -> FlowParams:
    """Name -> params, as the reference's ``make_flow_params``
    (pixflow.py:131-178, after makeOpticalFlowByName)."""
    if name == "pixflow_low":
        return FlowParams()
    if name == "pixflow_search_20":
        return FlowParams(search_max_percentage=20)
    if name == "pixflow_tpu":
        return FlowParams(
            pyr_scale_factor=0.5,
            prop_offsets=(8, 4, 2, 1),
            fine_prop_offsets=(2, 1),
            use_probe_candidates=True,
            rank_sampler="nearest",
            min_image_size=12,
            error_sampler_precision="default",
        )
    if name == "pixflow_tpu_offsets":
        return make_flow_params("pixflow_tpu")._replace(offset_ranking=True)
    if name == "pixflow_tpu_fast":
        return make_flow_params("pixflow_tpu")._replace(residual_rebase=True)
    if name == "pixflow_tpu_bf16":
        return make_flow_params("pixflow_tpu")
    if name == "pixflow_tpu_f32":
        return make_flow_params("pixflow_tpu")._replace(
            error_sampler_precision="float32"
        )
    raise ValueError(f"unrecognized flow algorithm name: {name}")


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


def _shift_with_edge(arr: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Content shifted by (dy, dx) with edge clamp: the value that lands at
    p came from p - (dy, dx), clamped into the frame."""
    H, W = arr.shape[-2:]
    iy = torch.clamp(torch.arange(H, device=arr.device) - dy, 0, H - 1)
    ix = torch.clamp(torch.arange(W, device=arr.device) - dx, 0, W - 1)
    return arr[..., iy, :][..., ix]


def _box5(img: torch.Tensor) -> torch.Tensor:
    """5x5 box sum with zero padding (patch SAD accumulations), summed in
    the reference's order: x then y, each as (((v + v[-1]) + v[+1]) +
    v[-2]) + v[+2]."""
    out = img
    for axis in (-1, -2):
        n = out.shape[axis]
        zeros = torch.zeros_like(out.narrow(axis, 0, 2))
        padded = torch.cat([zeros, out, zeros], dim=axis)
        acc = out
        for d in (1, 2):
            acc = acc + padded.narrow(axis, 2 - d, n) + padded.narrow(axis, 2 + d, n)
        out = acc
    return out


def _error_from_samples(flow, g, I0x, I0y, blurred_flow, params: FlowParams):
    """PixFlow energy (PixFlow.h:493-534) for candidate ``flow``
    (..., 2, H, W) given sampled I1 gradients ``g`` (..., 2, H, W)."""
    H, W = I0x.shape[-2:]
    data = torch.sqrt((I0x - g[..., 0, :, :]) ** 2 + (I0y - g[..., 1, :, :]) ** 2)
    fdiff = blurred_flow - flow
    smooth = torch.sqrt(fdiff[..., 0, :, :] ** 2 + fdiff[..., 1, :, :] ** 2)
    err = (
        data
        + smooth * params.smoothness_coef
        + params.vertical_regularization_coef * torch.abs(flow[..., 1, :, :]) / W
        + params.horizontal_regularization_coef * torch.abs(flow[..., 0, :, :]) / H
    )
    if params.use_directional_regularization:
        eps = 0.001
        bx, by = blurred_flow[..., 0, :, :], blurred_flow[..., 1, :, :]
        fx, fy = flow[..., 0, :, :], flow[..., 1, :, :]
        bmag = torch.sqrt(bx**2 + by**2)
        fmag = torch.sqrt(fx**2 + fy**2)
        dot = (bx * fx + by * fy) / ((bmag + eps) * (fmag + eps))
        err = err - params.directional_regularization_coef * dot
    return err


class _LevelPlan(NamedTuple):
    """A pyramid level's static geometry, from shapes and params alone."""

    offsets: tuple  # the jump-flooding distances of each sweep
    halo_y: int
    halo_x: int
    plan_kw: dict  # plan_windows_budgeted's arguments
    plan: object  # the generic candidate sampler's WindowPlan
    use_residual: bool
    r_halo: int


def _level_plan(B: int, H: int, W: int, params: FlowParams, is_finest: bool) -> _LevelPlan:
    offsets = (
        params.fine_prop_offsets
        if (is_finest and params.fine_prop_offsets)
        else params.prop_offsets
    )
    halo_x = max(params.window_min_halo, int(params.window_halo_x_frac * W))
    halo_y = max(params.window_min_halo, int(params.window_halo_y_frac * H))
    plan_kw = dict(
        interpolation="bilinear", border="clamp", tr=8,
        tc=params.window_tile_cols, elems_per_px=B * 2,
        max_window_elems=WINDOW_STACK_MAX_ELEMS,
    )
    plan = plan_windows_budgeted((H, W), (H, W), halo_y, halo_x, **plan_kw)
    # level rebasing (pixflow.py:513-560): warp the I1 gradients once by
    # the level's rounded incoming flow, then sample every error field at
    # the residual displacement, where the residual windows undercut the
    # full ones
    r_halo = 2 * sum(offsets) + 8
    tc_ = params.window_tile_cols
    residual_area = (tc_ + 2 * r_halo + 3) * (8 + 2 * r_halo + 3)
    use_residual = (
        params.residual_rebase
        and residual_area < 0.75 * (plan.bw * plan.bh)
        and plan.ntx * plan.nty > 1
    )
    return _LevelPlan(offsets, halo_y, halo_x, plan_kw, plan, use_residual, r_halo)


def _rank_offsets(d: int, probes) -> tuple:
    """The integer offsets one offset-ranking round samples at distance d:
    the centre, the probes, then the neighbours not among them."""
    offs = [(0, 0)] + [(py * d, px * d) for py, px in probes]
    for dy, dx in _NEIGHBOURS:
        if (dy * d, dx * d) not in offs:
            offs.append((dy * d, dx * d))
    return tuple(offs)


@lru_cache(maxsize=1024)
def _level_uses_kernel(B: int, H: int, W: int, params: FlowParams, is_finest: bool) -> bool:
    """Whether a pyramid level launches a hand-written kernel: an
    offset-ranking round whose sampler takes the fused route (K3), as
    :func:`~..ops.window_sampler.fused_route_plan` decides from shapes."""
    if not params.offset_ranking:
        return False
    lv = _level_plan(B, H, W, params, is_finest)
    if lv.use_residual:
        return False
    probes = _PROBES if params.use_probe_candidates else ()
    return any(
        fused_route_plan(
            B, 2, (H, W), (H, W), lv.halo_y, lv.halo_x, "bilinear", "clamp",
            _OFFSET_RANK_TR, _OFFSET_RANK_TC, params.error_sampler_precision,
            offsets=_rank_offsets(int(d), probes),
        ) is not None
        for d in lv.offsets
    )


def _propagation_and_search(
    I0, I1, alpha0, alpha1, flow, params: FlowParams, is_finest: bool,
    site: str = "",
):
    """One pyramid level. I0/I1/alpha0/alpha1 (B, H, W); flow (B, 2, H, W)."""
    B, H, W = I0.shape
    lv = _level_plan(B, H, W, params, is_finest)
    offsets, halo_y, halo_x, plan = lv.offsets, lv.halo_y, lv.halo_x, lv.plan
    blur = lambda a: gaussian_blur(a, GRADIENT_BLUR_SIGMA, ksize=GRADIENT_BLUR_KSIZE)
    I0x, I0y = blur(_sobel_k1(I0, -1)), blur(_sobel_k1(I0, -2))
    I1g = torch.stack([blur(_sobel_k1(I1, -1)), blur(_sobel_k1(I1, -2))], dim=-3)

    dev = I0.device
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    gate = (alpha0 > UPDATE_ALPHA_THRESHOLD) & (alpha1 > UPDATE_ALPHA_THRESHOLD)

    sampler_kw = dict(
        interpolation="bilinear", border="clamp", tr=8, tc=128,
        precision=params.error_sampler_precision, backend="xla",
    )
    # generic candidate sampling takes the plain route, as in the reference
    base_sample_fn = make_window_sampler(
        I1g, (H, W), halo_y, halo_x, xla_plan=plan, **sampler_kw
    )

    r_halo = lv.r_halo
    if lv.use_residual:
        f0x = torch.round(flow[..., 0, :, :])
        f0y = torch.round(flow[..., 1, :, :])
        J = base_sample_fn(
            torch.clamp(gx + f0x, 0.0, W - 2.0), torch.clamp(gy + f0y, 0.0, H - 2.0)
        )
        plan_r = plan_windows_budgeted((H, W), (H, W), r_halo, r_halo, **lv.plan_kw)
        res_sampler = make_window_sampler(
            J, (H, W), r_halo, r_halo, xla_plan=plan_r, **sampler_kw
        )

        def sample_fn(mx, my):
            qx = torch.clamp(mx - f0x, 0.0, W - 2.0)
            qy = torch.clamp(my - f0y, 0.0, H - 2.0)
            return res_sampler(qx, qy)
    else:
        sample_fn = base_sample_fn

    def error_field(cand, blurred_flow):
        # bilinear-extend sampling: coords clipped to [0, n-2]
        mx = torch.clamp(gx + cand[..., 0, :, :], 0.0, W - 2.0)
        my = torch.clamp(gy + cand[..., 1, :, :], 0.0, H - 2.0)
        return _error_from_samples(
            cand, sample_fn(mx, my), I0x, I0y, blurred_flow, params
        )

    def select_and_descend(flow, cand, errs, blurred_flow):
        """Best candidate per pixel, then one numeric-gradient descent
        step (PixFlow.h:195-217)."""
        curr_err, best = torch.min(errs, dim=0)
        idx = best[None, :, None].expand(1, B, 2, H, W)
        flow_prop = torch.gather(cand, 0, idx)[0]
        eps = device_constant((GRAD_EPSILON, 0.0), dev)[:, None, None]
        e2 = error_field(
            torch.stack([flow_prop + eps, flow_prop + eps.flip(0)]), blurred_flow
        )
        gflow = torch.stack([e2[0] - curr_err, e2[1] - curr_err], dim=-3) / GRAD_EPSILON
        flow_new = flow_prop - params.gradient_step_size * gflow
        return torch.where(gate[:, None], flow_new, flow)

    probes = _PROBES if params.use_probe_candidates else ()

    def round_d(flow, d, blurred_flow):
        cands = [flow] + [_shift(flow, dy * d, dx * d, flow) for dy, dx in _NEIGHBOURS]
        for py, px in probes:
            delta = device_constant((px * d, py * d), dev)
            cands.append(flow + delta[:, None, None])
        cand = torch.stack(cands, dim=0)  # (K, B, 2, H, W)
        return select_and_descend(flow, cand, error_field(cand, blurred_flow), blurred_flow)

    off_samplers: dict = {}

    def round_offsets(flow, d, blurred_flow):
        """One round whose candidates all sample at base_warp + a constant
        integer offset (pixflow.py:610-675): one offset-sampler call gives
        every candidate's samples."""
        offs = _rank_offsets(d, probes)
        if offs not in off_samplers:
            # the last column and row repeat column / row n-2, so the
            # sampler's tap clamp reproduces the clip to [0, n-2]
            I1g_ext = I1g.clone()
            I1g_ext[..., :, W - 1] = I1g_ext[..., :, W - 2]
            I1g_ext[..., H - 1, :] = I1g_ext[..., H - 2, :]
            off_samplers[offs] = make_window_sampler(
                I1g_ext, (H, W), halo_y, halo_x, "bilinear", "clamp",
                tr=_OFFSET_RANK_TR, tc=_OFFSET_RANK_TC,
                precision=params.error_sampler_precision, offsets=offs,
                site=site,
            )
        bx = torch.clamp(gx + flow[..., 0, :, :], 0.0, W - 2.0)
        by = torch.clamp(gy + flow[..., 1, :, :], 0.0, H - 2.0)
        gofs = off_samplers[offs](bx, by)  # (O, B, 2, H, W)
        idx = {o: i for i, o in enumerate(offs)}
        cands, datas = [flow], [gofs[0]]
        for dy, dx in _NEIGHBOURS:
            v = (dy * d, dx * d)
            cands.append(_shift(flow, *v, flow))
            datas.append(_shift(gofs[idx[v]], *v, gofs[0]))
        for py, px in probes:
            delta = device_constant((px * d, py * d), dev)
            cands.append(flow + delta[:, None, None])
            datas.append(gofs[idx[(py * d, px * d)]])
        cand = torch.stack(cands, dim=0)  # (K, B, 2, H, W)
        i1 = torch.stack(datas, dim=0)
        # beyond-halo candidates read zero samples, as the windowed
        # sampler's dropped taps do
        beyond = (cand[..., 0, :, :].abs() > halo_x) | (cand[..., 1, :, :].abs() > halo_y)
        i1 = torch.where(beyond[:, :, None], 0.0, i1)
        errs = _error_from_samples(cand, i1, I0x, I0y, blurred_flow, params)
        return select_and_descend(flow, cand, errs, blurred_flow)

    one_round = (
        round_offsets if params.offset_ranking and not lv.use_residual else round_d
    )

    def sweep(flow):
        blurred_flow = gaussian_blur(flow, BLURRED_FLOW_SIGMA, ksize=BLURRED_FLOW_KSIZE)
        for d in offsets:
            flow = one_round(flow, int(d), blurred_flow)
        return flow

    # two sweeps with a 5x5 median between and after (PixFlow.h:388-411)
    if params.rank_sampler == "nearest":
        med = median_filter_5x5_separable
    else:
        med = lambda f: median_filter(f, MEDIAN_BLUR_SIZE)
    flow = med(sweep(flow))
    flow = med(sweep(flow))

    # low-alpha diffusion toward the blurred flow (PixFlow.h:437-454)
    blurred_flow = gaussian_blur(flow, BLURRED_FLOW_SIGMA, ksize=BLURRED_FLOW_KSIZE)
    diffusion = (1.0 - alpha0 * alpha1)[:, None]
    return diffusion * blurred_flow + (1.0 - diffusion) * flow


def _search_distance(params: FlowParams) -> int:
    return (PYR_MIN_IMAGE_SIZE * params.search_max_percentage + 50) // 100


@lru_cache(maxsize=64)
def _search_offsets(params: FlowParams) -> tuple:
    """Static union of the 4 hint boxes (computeSearchBox,
    PixFlow.h:279-296) as sorted (dy, dx, hints) triples."""
    dist = _search_distance(params)
    ortho = (dist + 4) // 8
    boxes = {
        HINT_RIGHT: (range(-ortho, ortho + 1), range(0, dist + 1)),
        HINT_LEFT: (range(-ortho, ortho + 1), range(-dist, 1)),
        HINT_DOWN: (range(0, dist + 1), range(-ortho, ortho + 1)),
        HINT_UP: (range(-dist, 1), range(-ortho, ortho + 1)),
    }
    union: dict = {}
    for hint, (dys, dxs) in boxes.items():
        for dy in dys:
            for dx in dxs:
                union.setdefault((dy, dx), set()).add(hint)
    return tuple((dy, dx, tuple(sorted(h))) for (dy, dx), h in sorted(union.items()))


@lru_cache(maxsize=64)
def _search_boxes(params: FlowParams) -> tuple:
    """The offsets the search tries against its start, (0, 0): (dy, dx)
    pairs, and a table with one row each of the hints whose box holds
    it, padded with 0.5, which no hint equals."""
    tried = [(dy, dx, h) for dy, dx, h in _search_offsets(params) if (dy, dx) != (0, 0)]
    width = max(len(h) for *_, h in tried)
    table = tuple(h + (0.5,) * (width - len(h)) for *_, h in tried)
    return tuple((dy, dx) for dy, dx, _ in tried), table


def _adjust_initial_flow(I0, I1, alpha0, alpha1, flow, hint, params: FlowParams):
    """Brute-force 5x5-SAD search over the hint box at the coarsest level
    (adjustInitialFlow, PixFlow.h:298-342), per batch element's hint
    ``hint`` (B,). Every offset of the boxes' union is evaluated; a batch
    element takes an offset only where its hint's box holds it. The hint
    boxes are one device constant, tested against ``hint`` on the device:
    no upload and no synchronise after the first call."""
    B, H, W = I0.shape
    # poor man's color correction (PixFlow.h:261-277)
    a = alpha0 * alpha1
    ratio = per_image(torch.sum, a * I0) / (per_image(torch.sum, a * I1) + 1e-12)
    I1eq = I1 * ratio[:, None, None]
    dist = _search_distance(params)

    def patch_error(dy, dx):
        shifted_i1 = _shift_with_edge(I1eq, -dy, -dx)  # I1eq at p + (dy, dx)
        shifted_a1 = _shift_with_edge(alpha1, -dy, -dx)
        sad = _box5(torch.abs(I0 - shifted_i1))
        asum = _box5(alpha0 * shifted_a1)
        err = sad / torch.clamp(asum, min=1e-12)
        return err * (1.0 + float(np.hypot(dx, dy)) / max(dist, 1))

    tried, table = _search_boxes(params)
    boxes = device_constant(table, I0.device)
    hint_ok = (hint[None, :, None] == boxes[:, None, :]).any(-1)  # (offsets, B)
    best_err = 0.8 * patch_error(0, 0)
    best_dy = torch.zeros((B, H, W), dtype=torch.float32, device=I0.device)
    best_dx = torch.zeros_like(best_dy)
    for i, (dy, dx) in enumerate(tried):
        err = torch.where(hint_ok[i][:, None, None], patch_error(dy, dx), torch.inf)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_dy = torch.where(better, float(dy), best_dy)
        best_dx = torch.where(better, float(dx), best_dx)
    found = alpha0 > UPDATE_ALPHA_THRESHOLD
    return torch.where(found[:, None], torch.stack([best_dx, best_dy], dim=1), flow)


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


def _level_inputs(src, level: int, lh: int, lw: int):
    """The level's I0, I1, alpha0, alpha1, resized from the working
    resolution (the finest level takes them as they are)."""
    return [resize_bilinear(t, (lh, lw)) if level else t for t in src[:4]]


def _search_step(src, flow, level: int, sizes, params: FlowParams, hint):
    """The hinted search of :func:`compute_flow` at the coarsest level
    ``level``: src as :func:`_level_step`'s, ``flow`` the flow where the
    search finds nothing (zero where None), ``hint`` (B,). Returns the
    level's starting flow."""
    lh, lw = sizes[level]
    inputs = _level_inputs(src, level, lh, lw)
    if flow is None:
        flow = torch.zeros((inputs[0].shape[0], 2, lh, lw), dtype=torch.float32,
                           device=inputs[0].device)
    return _adjust_initial_flow(*inputs, flow, hint, params)


def _level_step(src, flow, level: int, sizes, params: FlowParams,
                use_temporal: bool, site: str):
    """One pyramid level of :func:`compute_flow`: src = (I0, I1, alpha0,
    alpha1[, prev_flow_d, motion]) at the working resolution, ``flow`` the
    incoming flow at this level's size (None at the coarsest level without
    a search, which starts from zero). Returns the flow upsampled to the
    next finer level (the finest level's own flow at level 0)."""
    lh, lw = sizes[level]
    I0l, I1l, a0l, a1l = _level_inputs(src, level, lh, lw)
    if flow is None:
        B = I0l.shape[0]
        flow = torch.zeros((B, 2, lh, lw), dtype=torch.float32, device=I0l.device)
    flow = _propagation_and_search(
        I0l, I1l, a0l, a1l, flow, params, is_finest=(level == 0), site=site
    )
    if use_temporal:
        # adjustFlowTowardPrevious (PixFlow.h:185-193)
        prev_flow_d, motion = src[4:]
        prev_l = resize_cubic(prev_flow_d, (lh, lw)) * (lh / src[0].shape[-2])
        w = (1.0 - resize_bilinear(motion, (lh, lw)))[:, None]
        flow = flow * (1.0 - w) + prev_l * w
    if level > 0:
        flow = resize_cubic(flow, sizes[level - 1]) * (1.0 / params.pyr_scale_factor)
    return flow


# CUDA graphs of the pyramid levels. A level's work is several hundred
# small tensor operations on shapes fixed by the rig and preset, and no
# host decision inside it depends on data, so each level that launches no
# hand-written kernel is captured once per key and replayed: the same
# kernels in the same order, a fraction of the host's launch time. The
# hinted search in front of the coarsest level is a graph of its own.


def _graphable(device: torch.device) -> bool:
    return device.type == "cuda"


@lru_cache(maxsize=1024)
def _level_graphed(device: torch.device, B: int, h: int, w: int,
                   params: FlowParams, is_finest: bool) -> bool:
    """Whether a level runs as a CUDA graph: on a CUDA device, where it
    launches no hand-written kernel. A level that launches K3 stays eager
    because a replay would skip the Python of its calls: the launch call
    (``cuda_build.launch``, which counts each launch) and the per-call hook
    (``fused_window._record``) must see every call."""
    return _graphable(device) and not _level_uses_kernel(B, h, w, params, is_finest)


def _graph_key(device: torch.device, site: str, params: FlowParams,
               use_temporal: bool, B: int, level: int, size, work) -> tuple:
    """Everything a level's launches depend on: the device, the call site,
    the params, the temporal prior, the batch, the level's index and size
    and the working resolution ``work``."""
    return (device, site, params, use_temporal, B, level, tuple(size), tuple(work))


class _LevelGraph(NamedTuple):
    """A captured level or search."""

    graph: object  # torch.cuda.CUDAGraph (anything with replay())
    flow_in: torch.Tensor | None  # the incoming flow the graph reads
    copy_in: bool  # whether each call copies its incoming flow to flow_in
    out: torch.Tensor  # the flow the graph writes


class _DeviceGraphs:
    """One device's level graphs: one memory pool, persistent buffers and
    a lock, since every graph reads those buffers and shares the pool. A
    call holds the lock from loading its inputs to its last read of a
    graph's output, so the graphs run one call at a time and in call
    order.

    A call's buffers (:meth:`layout`) are its inputs at the working
    resolution, its hints, and one flow buffer of the finest level's size,
    which every level reads its incoming flow from (a prefix, viewed at
    the level's size) and writes its result to, as its last operation,
    after every read of its input; the search writes the coarsest level's
    incoming flow there. Every call loads its inputs, so the calls of all
    keys share the buffers' memory: views of one arena, laid out for the
    temporal prior's inputs whether a call has them or not, so that a
    video's first frame and the later ones fit the same arena."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.graphs: dict = {}  # graph key -> _LevelGraph
        self.arenas: list = []  # flat float32 buffers the layouts view
        self.layouts: dict = {}  # (B, h, w) -> the buffers' views
        self.pool = None  # graph memory pool, shared by every graph here
        self.stream = None  # side stream of the warm-ups and captures
        self.done = None  # event after the last call's work, and its stream
        self.done_stream = None

    def layout(self, B: int, h: int, w: int, temporal: bool):
        """Views for a call of batch ``B`` at working resolution (h, w): its
        inputs (I0, I1, alpha0, alpha1, and with ``temporal`` prev_flow_d
        and motion), the flow buffer (B, 2, h, w) and the hints (B,)
        int32; each at a 512-byte boundary, as the allocator places a
        tensor, in the first arena large enough or in a new one. The same
        views at every call, since the graphs read them by address."""
        views = self.layouts.get((B, h, w))
        if views is None:
            plane, field = (B, h, w), (B, 2, h, w)
            # ..., flow, prev, motion, hints
            shapes = (plane,) * 4 + (field, field, plane, (B,))
            starts, end = [], 0
            for shape in shapes:
                starts.append(end)
                end += -(-math.prod(shape) // 128) * 128
            arena = next((a for a in self.arenas if a.numel() >= end), None)
            if arena is None:
                arena = torch.empty(end, dtype=torch.float32, device=self.device)
                self.arenas.append(arena)
            views = [arena[o:o + math.prod(sh)].view(sh) for o, sh in zip(starts, shapes)]
            views[-1] = views[-1].view(torch.int32)
            self.layouts[(B, h, w)] = views
        inputs = views[:4] + (views[5:7] if temporal else [])
        return tuple(inputs), views[4], views[7]

    @contextmanager
    def use(self):
        """Hold the device's graphs for one call; a call on another stream
        than the last one's first waits for the last one's work."""
        with self.lock:
            if self.device.type != "cuda":
                yield self
                return
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream()
                if self.done is not None and self.done_stream != stream:
                    stream.wait_event(self.done)
                yield self
                if self.done is None:
                    self.done = torch.cuda.Event()
                self.done.record(stream)
                self.done_stream = stream


_DEVICE_GRAPHS: dict = {}  # device -> _DeviceGraphs
_DEVICE_GRAPHS_LOCK = threading.Lock()


def _device_graphs(device: torch.device) -> _DeviceGraphs:
    with _DEVICE_GRAPHS_LOCK:
        dg = _DEVICE_GRAPHS.get(device)
        if dg is None:
            dg = _DEVICE_GRAPHS[device] = _DeviceGraphs(device)
        return dg


def _capture(step, out: torch.Tensor, dg: _DeviceGraphs):
    """Warm ``step`` up eagerly on the device's side stream (it fills the
    caches and the library handles that capture may not create; its
    result is dropped, since ``out`` may overlap its input), then capture
    ``out.copy_(step())`` into a CUDA graph on that stream, into the
    device's pool, pinning the cached device tensors it reads. Returns
    the graph."""
    if dg.stream is None:
        dg.stream = torch.cuda.Stream(dg.device)
        dg.pool = torch.cuda.graph_pool_handle()
    current = torch.cuda.current_stream()
    graph = torch.cuda.CUDAGraph()
    # torch.cuda.graph's own entry would synchronise and empty the memory
    # caches at every capture: a cost in set-up and nothing a capture needs
    with pinning():
        dg.stream.wait_stream(current)
        with torch.cuda.stream(dg.stream):
            step()
            graph.capture_begin(dg.pool, capture_error_mode="thread_local")
            try:
                out.copy_(step())
            finally:
                graph.capture_end()
        current.wait_stream(dg.stream)
    return graph


def _flow_view(flow_buf: torch.Tensor, size) -> torch.Tensor:
    B = flow_buf.shape[0]
    return flow_buf.view(-1)[: B * 2 * size[0] * size[1]].view(B, 2, *size)


def _run_graphed(dg: _DeviceGraphs, key: tuple, body, flow_buf, flow, out_size,
                 prev: _LevelGraph | None = None) -> _LevelGraph:
    """Replay graph ``key`` of ``body(flow_in)``, capturing it first where
    the key is new: a level's body reads its incoming flow ``flow`` (None
    at a start from zero), the search's none. Returns the graph, whose
    ``out`` (a view of ``flow_buf`` at ``out_size``) holds the result;
    ``flow`` read from ``prev.out`` is read in place."""
    rec = dg.graphs.get(key)
    if rec is None:
        count("flow.graph.capture")
        if flow is None or (prev is not None and flow is prev.out):
            flow_in, copy_in = flow, False
        else:
            flow_in, copy_in = _flow_view(flow_buf, flow.shape[-2:]), True
            flow_in.copy_(flow)
        out = _flow_view(flow_buf, out_size)
        graph = _capture(lambda: body(flow_in), out, dg)
        rec = dg.graphs[key] = _LevelGraph(graph, flow_in, copy_in, out)
    else:
        count("flow.graph.replay")
        if rec.copy_in:
            rec.flow_in.copy_(flow)
        elif flow is not rec.flow_in:
            raise RuntimeError(f"flow graph {key} was captured on another input")
    rec.graph.replay()
    return rec


def compute_flow(
    img0: torch.Tensor,
    img1: torch.Tensor,
    params: FlowParams,
    hint=None,
    prev_flow=None,
    prev_img0=None,
    prev_img1=None,
    use_temporal: bool = False,
    site: str = "",
) -> torch.Tensor:
    """Optical flow img0 -> img1 (computeOpticalFlow, PixFlow.h:81-183).

    img0/img1 (B, 4, H, W) RGBA float32 in [0,1]; hint (B,) int direction
    hints (HINT_*), used when ``params.search_max_percentage > 0``;
    prev_*: the previous frame's flow (B, 2, h, w) and images, used when
    ``use_temporal`` (``prev_img0`` is unused, as in the reference).
    ``site`` labels the sampler kernel's launches. Returns (B, 2, H, W)
    pixels at input resolution.

    On a CUDA device each pyramid level that launches no hand-written
    kernel (:func:`_level_graphed`) runs as a CUDA graph, captured at the
    first call with its key (:func:`_graph_key`) and replayed after: the
    prologue's results and ``hint`` are copied into the device's
    persistent buffers, the graphs read those and each other's outputs,
    the hinted search runs as a graph of its own (the coarsest level's key
    and ``"search"``) in front of the coarsest level's graph where that
    level is graphed, and the final resize and blur read the finest
    level's output into a fresh tensor. On the CPU everything runs
    eagerly.

    Traced as a span ``flow`` (``site``, ``batch``) holding one
    ``flow.level`` span per pyramid level (``level``, 0 the finest;
    ``finest``; the level's ``h``, ``w``; ``graphed``), which counts
    ``flow.graph.capture``, ``flow.graph.replay`` or ``flow.graph.eager``.
    With the search, the coarsest level's span holds a span
    ``flow.search`` (``site``; the level's ``h``, ``w``; ``offsets``, the
    offsets tried besides the start; ``graphed``), which counts
    ``flow.search.offsets`` (the offsets evaluated) and how the search
    ran, under the same three ``flow.graph.*`` names."""
    B, C, H, W = img0.shape
    if C != 4:
        raise ValueError("expected RGBA input")
    dev = img0.device
    if hint is None:
        hint = torch.full((B,), HINT_UNKNOWN, dtype=torch.int32, device=dev)
    with span("flow", site=site, batch=B):
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
        src = (I0, I1, alpha0, alpha1) + ((prev_flow_d, motion) if use_temporal else ())

        sizes = _pyramid_sizes(dh, dw, params)
        graphed = [_level_graphed(dev, B, lh, lw, params, level == 0)
                   for level, (lh, lw) in enumerate(sizes)]
        search = hint if params.search_max_percentage > 0 else None
        if not any(graphed):
            flow = _levels(src, None, search, sizes, graphed, params, use_temporal, site)
            return _final_flow(flow, H, W, params)
        with _device_graphs(dev).use() as dg:
            static, flow_buf, hint_buf = dg.layout(B, dh, dw, use_temporal)
            for buf, t in zip(static, src):
                buf.copy_(t)
            if search is not None:
                hint_buf.copy_(search)
            flow = _levels(src, (dg, static, flow_buf, hint_buf), search, sizes, graphed,
                           params, use_temporal, site)
            return _final_flow(flow, H, W, params)


def _levels(src, graphs, search, sizes, graphed, params: FlowParams,
            use_temporal: bool, site: str):
    """The pyramid from the coarsest level to the finest: eager levels on
    ``src``, graphed ones through ``graphs`` = (the device's graphs, the
    loaded copies of ``src``, the flow buffer, the loaded hints)."""
    B = src[0].shape[0]
    flow, prev = None, None
    for level in range(len(sizes) - 1, -1, -1):
        lh, lw = sizes[level]
        g = graphed[level]
        with span("flow.level", level=level, finest=level == 0, h=lh, w=lw, graphed=g):
            key = None
            if g:
                dg, static, flow_buf, hint_buf = graphs
                key = _graph_key(dg.device, site, params, use_temporal, B, level, (lh, lw),
                                 sizes[0])
            if flow is None and search is not None:
                tried = len(_search_boxes(params)[0])
                with span("flow.search", site=site, h=lh, w=lw, offsets=tried, graphed=g):
                    count("flow.search.offsets", tried)
                    if g:
                        body = partial(_search_step, static, level=level, sizes=sizes,
                                       params=params, hint=hint_buf)
                        prev = _run_graphed(dg, key + ("search",), body, flow_buf, None,
                                            (lh, lw))
                        flow = prev.out
                    else:
                        count("flow.graph.eager")
                        flow = _search_step(src, None, level, sizes, params, search)
            if not g:
                count("flow.graph.eager")
                flow = _level_step(src, flow, level, sizes, params, use_temporal, site)
                prev = None
                continue
            body = partial(_level_step, static, level=level, sizes=sizes, params=params,
                           use_temporal=use_temporal, site=site)
            prev = _run_graphed(dg, key, body, flow_buf, flow, sizes[max(level - 1, 0)], prev)
            flow = prev.out
    return flow


def _final_flow(flow, H: int, W: int, params: FlowParams) -> torch.Tensor:
    """The finest level's flow at input resolution, blurred: a fresh tensor."""
    flow = resize_bilinear(flow, (H, W)) * (1.0 / params.downscale_factor)
    return gaussian_blur(flow, FINAL_FLOW_BLUR_SIGMA, ksize=FINAL_FLOW_BLUR_KSIZE)
