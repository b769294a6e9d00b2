"""Color calibration: MacBeth chart -> ISP parameters (black level, white
balance, CCM) + DeltaE quality report.

Port of ``surround360_tpu/calib/color.py`` (reference:
surround360_render/source/calibration/ColorCalibration.{h,cpp}). The joint
solve is a dense Levenberg-Marquardt in float64 on the device (<= 20 free
parameters, 24 x 3 residuals; the reference package runs it in float32):

  minimize sum_i || Lab_gt_i - Lab(M (s_i * RGB_i - BL) / (1 - BL)) ||^2

where the per-patch illumination s_i is a separable order-4 x order-4
Bezier surface over the chart (IspFunctor, ColorCalibration.cpp:78-165),
black level is boxed to [0, 1], and the first Bezier control points are
locked at 1. The solved 3x3 M is decomposed into whiteBalanceGain +
row-normalized CCM as the reference does (ColorCalibration.cpp:1312-1340).

Chart *detection* (:func:`detect_color_chart`) follows detectColorChart
(ColorCalibration.cpp:504-917) stage for stage without OpenCV: the
per-pixel stages (grey, the fixed-point Gaussian blur, the adaptive
threshold, the morphology) run on the device in integer arithmetic that
reproduces OpenCV's, the connected components on the host with
``scipy.ndimage``, and the contour geometry (border following, Douglas-
Peucker, convexity, minimum-area rectangles, the filled-quad masks) on the
host in numpy, each after the OpenCV function it replaces. One deliberate
difference: a candidate quad that contains another candidate's centre
(only the chart's own outline can) is dropped before the outlier step; the
reference keeps it and then finds 25 patches where the chart covers
little of the frame.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ..utils.math_util import fma_f32

__all__ = [
    "LAB_MACBETH",
    "rgb_to_lab",
    "solve_isp_color_params",
    "delta_e_report",
    "detect_color_chart",
]

# MacBeth ColorChecker Lab references (Danny Pascale / BabelColor 2006),
# as used in ColorCalibration.h:42-94
LAB_MACBETH = {
    "D50": np.array(
        [
            [37.99, 13.56, 14.06], [65.71, 18.13, 17.81],
            [49.93, -4.88, -21.93], [43.14, -13.10, 21.91],
            [55.11, 8.84, -25.40], [70.72, -33.40, -0.199],
            [62.66, 36.07, 57.10], [40.02, 10.41, -45.96],
            [51.12, 48.24, 16.25], [30.33, 22.98, -21.59],
            [72.53, -23.71, 57.26], [71.94, 19.36, 67.86],
            [28.78, 14.18, -50.30], [55.26, -38.34, 31.37],
            [42.10, 53.38, 28.19], [81.73, 4.04, 79.82],
            [51.94, 49.99, -14.57], [51.04, -28.63, -28.64],
            [96.54, -0.425, 1.186], [81.26, -0.638, -0.335],
            [66.77, -0.734, -0.504], [50.87, -0.153, -0.270],
            [35.66, -0.421, -1.231], [20.46, -0.079, -0.973],
        ]
    ),
    "D65": np.array(
        [
            [37.85, 12.72, 14.07], [65.43, 17.18, 17.21],
            [50.15, -1.91, -21.79], [43.17, -15.08, 22.44],
            [55.40, 11.58, -25.06], [70.92, -33.22, 0.29],
            [62.06, 33.37, 56.24], [40.59, 16.15, -45.14],
            [50.58, 47.55, 15.17], [30.51, 25.11, -21.74],
            [72.31, -27.84, 57.83], [71.43, 15.50, 67.80],
            [29.46, 20.74, -49.34], [55.26, -41.23, 32.03],
            [41.53, 52.67, 26.92], [81.08, -0.33, 80.10],
            [51.74, 51.26, -15.48], [52.41, -18.46, -26.64],
            [96.49, -0.35, 0.96], [81.17, -0.69, -0.24],
            [66.84, -0.71, -0.25], [50.86, 0.20, -0.55],
            [35.61, -0.36, -1.44], [20.40, 0.47, -1.27],
        ]
    ),
}

_WHITE = {
    "D50": np.array([0.96422, 1.00000, 0.82521]),
    "D65": np.array([0.95047, 1.00000, 1.08883]),
}
_RGB2XYZ = {
    "D50": np.array(
        [
            [0.4360747, 0.3850649, 0.1430804],
            [0.2225045, 0.7168786, 0.0606169],
            [0.0139322, 0.0971045, 0.7141733],
        ]
    ),
    "D65": np.array(
        [
            [0.4124564, 0.3575761, 0.1804375],
            [0.2126729, 0.7151522, 0.0721750],
            [0.0193339, 0.1191920, 0.9503041],
        ]
    ),
}


def rgb_to_lab(rgb, illuminant: str = "D50"):
    """Linear RGB (..., 3) -> CIELAB via the Bradford-adapted matrices
    (ColorspaceConversion.h:57-101); a tensor gives a tensor of its dtype
    and device, anything else a numpy array. The cube root's argument is
    clamped at 1e-12 in both branches, so the derivative stays finite
    where the linear branch is taken."""
    m = _RGB2XYZ[illuminant] / _WHITE[illuminant][:, None]
    if isinstance(rgb, torch.Tensor):
        m = torch.as_tensor(m, dtype=rgb.dtype, device=rgb.device)
        xyz = torch.stack([torch.sum(m[i] * rgb, dim=-1) for i in range(3)], dim=-1)
        cbrt = torch.pow(torch.clamp(xyz, min=1e-12), 1.0 / 3.0)
        f = torch.where(xyz > 0.008856, cbrt, 7.787 * xyz + 16.0 / 116.0)
        stack = torch.stack
    else:
        rgb = np.asarray(rgb, dtype=np.float64)
        xyz = np.stack([np.sum(m[i] * rgb, axis=-1) for i in range(3)], axis=-1)
        f = np.where(xyz > 0.008856, np.cbrt(np.maximum(xyz, 1e-12)),
                     7.787 * xyz + 16.0 / 116.0)
        stack = np.stack
    L = 116.0 * f[..., 1] - 16.0
    A = 500.0 * (f[..., 0] - f[..., 1])
    B = 200.0 * (f[..., 1] - f[..., 2])
    return stack([L, A, B], -1)


def _bezier_1d(ctrl, t):
    pts = [ctrl[i] for i in range(ctrl.shape[0])]
    while len(pts) > 1:
        pts = [pts[i] + t * (pts[i + 1] - pts[i]) for i in range(len(pts) - 1)]
    return pts[0]


@dataclass
class ColorCalibrationResult:
    black_level: np.ndarray  # (3,) in [0,1]
    white_balance: np.ndarray  # (3,)
    ccm: np.ndarray  # (3,3), rows sum to 1
    illumination_bezier_x: np.ndarray
    illumination_bezier_y: np.ndarray
    final_cost: float


def solve_isp_color_params(
    patch_rgbs: np.ndarray,  # (P, 3) medians in [0,1], raster order
    patch_centroids: np.ndarray,  # (P, 2) pixel coords
    illuminant: str = "D50",
    black_level=None,  # (3,) locks BL when given (isBlackLevelSet)
    iterations: int = 200,
    device="cuda",
) -> ColorCalibrationResult:
    """The joint solve in float64 on ``device``: residuals over the
    20-vector [bezierX[1:5], bezierY[1:5], bl(3), M(9)], the Jacobian by
    ``torch.func.jacfwd``, and the reference's LM policy (lambda from 1e-3,
    at most 8 tries an iteration, x10 on a singular system or a rejected
    step, /10 down to 1e-12 on an accepted one, the black level clipped to
    [0, 1] after each step, stop at the first iteration without progress).
    One host sync per try reads its cost and whether the solve was
    singular."""
    device = torch.device(device)
    f64 = torch.float64
    rgbs = torch.as_tensor(np.asarray(patch_rgbs, np.float64), device=device)
    lab_ref = torch.as_tensor(LAB_MACBETH[illuminant][: len(rgbs)], device=device)

    c = np.asarray(patch_centroids, dtype=np.float64)
    span = c.max(axis=0) - c.min(axis=0)
    uv = torch.as_tensor((c - c[0]) / np.maximum(span, 1e-9), device=device)

    bl0 = np.zeros(3) if black_level is None else np.asarray(black_level, np.float64)
    theta = torch.as_tensor(
        np.concatenate([np.ones(4), np.ones(4), bl0, np.eye(3).reshape(-1)]), device=device
    )
    one = torch.ones(1, dtype=f64, device=device)
    zero = torch.zeros((), dtype=f64, device=device)

    def unpack(theta):
        bx = torch.cat([one, theta[0:4]])
        by = torch.cat([one, theta[4:8]])
        # jnp.clip's derivative: half of it where the value sits on a bound
        bl = torch.minimum(torch.maximum(theta[8:11], zero), zero + 1.0)
        return bx, by, bl, theta[11:20].reshape(3, 3)

    def residuals(theta):
        bx, by, bl, M = unpack(theta)
        s = _bezier_1d(bx, uv[:, 0]) * _bezier_1d(by, uv[:, 1])  # (P,)
        rgb_bl = (rgbs - bl) / (1.0 - bl + 1e-16) * s[:, None]
        return (lab_ref - rgb_to_lab(rgb_bl @ M.T, illuminant)).reshape(-1)

    jacobian = torch.func.jacfwd(residuals)
    free = torch.arange(20, device=device)
    if black_level is not None:
        free = free[(free < 8) | (free >= 11)]

    lam = 1e-3
    r = residuals(theta)
    cost = float(0.5 * (r @ r))
    for _ in range(iterations):
        J = jacobian(theta)[:, free]
        g = J.T @ r
        H = J.T @ J
        diag = torch.diag(torch.clamp(torch.diagonal(H), min=1e-9))
        improved = False
        for _try in range(8):
            step, info = torch.linalg.solve_ex(H + lam * diag, -g)
            new_theta = theta.index_add(0, free, step)
            new_theta[8:11] = torch.clamp(new_theta[8:11], 0.0, 1.0)
            new_r = residuals(new_theta)
            new_cost, singular = torch.stack(
                [0.5 * (new_r @ new_r), info.to(f64)]
            ).tolist()
            if singular:
                lam *= 10
                continue
            if new_cost < cost:
                theta, r, cost = new_theta, new_r, new_cost
                lam = max(lam / 10, 1e-12)
                improved = True
                break
            lam *= 10
        if not improved:
            break

    bx, by, bl, M = (v.cpu().numpy() for v in unpack(theta))

    # decompose M into WB + row-normalized CCM (ColorCalibration.cpp:1312+):
    # WB from M^-1 * ones scaled to the most sensitive channel, then
    # CCM = M * WB^-1 with rows normalized to sum 1
    balanced = np.linalg.inv(M) @ np.ones(3)
    wb = balanced.max() / balanced
    ccm = M * (1.0 / wb)[None, :]
    ccm = ccm / ccm.sum(axis=1, keepdims=True)

    return ColorCalibrationResult(
        black_level=bl,
        white_balance=wb,
        ccm=ccm,
        illumination_bezier_x=bx,
        illumination_bezier_y=by,
        final_cost=cost,
    )


def delta_e_report(patch_rgbs: np.ndarray, illuminant: str = "D50") -> dict:
    """CIE76 DeltaE per patch of corrected RGB medians vs ground truth
    (computeColorPatchErrors, ColorCalibration.cpp:1410+)."""
    lab = rgb_to_lab(np.asarray(patch_rgbs, np.float64), illuminant)
    ref = LAB_MACBETH[illuminant][: len(patch_rgbs)]
    de = np.linalg.norm(lab - ref, axis=1)
    return {
        "mean": float(de.mean()),
        "median": float(np.median(de)),
        "max": float(de.max()),
        "per_patch": de.tolist(),
    }


def build_color_adjustment_model(
    target_rgba: np.ndarray,  # (4, H, W) float [0,1]
    adjust_rgba: np.ndarray,
    sample_rate: int = 100,
    alpha_threshold: float = 250.0 / 255.0,
    seed: int = 0,
) -> np.ndarray:
    """Affine color-difference model between two overlapping images
    (buildColorAdjustmentModel, CvUtil.cpp:262-310): least-squares fit of
    [1, r, g, b] -> (target - adjust) over randomly sampled pixels where
    both alphas are (nearly) opaque. Returns (4, 3) coefficients; apply as
    adjusted = adjust + features @ M. Host numpy, drawing from
    ``np.random.default_rng(seed)`` in the reference's order."""
    rng = np.random.default_rng(seed)
    t = np.moveaxis(np.asarray(target_rgba), 0, -1).reshape(-1, 4)
    a = np.moveaxis(np.asarray(adjust_rgba), 0, -1).reshape(-1, 4)
    opaque = (t[:, 3] > alpha_threshold) & (a[:, 3] > alpha_threshold)
    sampled = opaque & (rng.integers(0, sample_rate, len(t)) == 0)
    if sampled.sum() < 8:
        sampled = opaque
    feats = np.concatenate([np.ones((sampled.sum(), 1)), a[sampled, :3]], axis=1)
    deltas = a[sampled, :3] - t[sampled, :3]
    coef, *_ = np.linalg.lstsq(feats, deltas, rcond=None)
    return -coef  # model predicts the correction toward the target


# ---------------------------------------------------------------------------
# chart detection: the per-pixel stages (device)

BLUR_KSIZE = 15  # GaussianBlur((15, 15), 0)
THRESH_BLOCK = 19  # adaptiveThreshold block size
THRESH_C = 2  # and its constant (BINARY_INV compares with -floor(C))


def grey_f32(image_rgb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) RGB -> (H, W) float32 grey as cvtColor(RGB2GRAY) computes
    it on float32 (OpenCV's vector loop: fma(B, .114, fma(R, .299, G *
    .587)), each fused multiply-add rounded once to float32)."""
    c = [torch.tensor(float(np.float32(v)), dtype=torch.float32) for v in (0.299, 0.587, 0.114)]
    r, g, b = image_rgb.to(torch.float32).unbind(0)
    return fma_f32(b, c[2], fma_f32(r, c[0], g * c[1]))


def grey_u8(image_rgb: torch.Tensor) -> torch.Tensor:
    """(3, H, W) float32 RGB -> (H, W) uint8: :func:`grey_f32`, then
    clip(2 * grey * 255, 0, 255) truncated as numpy's astype(uint8) does
    (ColorCalibration.cpp:515-523)."""
    scaled = grey_f32(image_rgb) * 2.0 * 255.0
    return torch.clamp(scaled, 0, 255).to(torch.uint8)


def _gaussian_kernel_u8(n: int) -> list[int]:
    """OpenCV's bit-exact Gaussian kernel for 8-bit images: sigma 0.15 n +
    0.35, 8 fraction bits, rounding error diffused from the tails and the
    centre tap taking the rest of 256 (getGaussianKernelBitExact,
    getGaussianKernelFixedPoint_ED)."""
    sigma = n * 0.15 + 0.35
    vals = [math.exp(x * x * (-0.125 / (sigma * sigma))) for x in range(1 - n, 0, 2)]
    total = 2.0 * sum(vals) + 1.0
    err, taps = 0.0, []
    for v in vals:
        adj = v / total * 256 + err
        q = int(np.rint(adj))
        err = adj - q
        taps.append(q)
    return taps + [256 - 2 * sum(taps)] + taps[::-1]


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur_u8(u8: torch.Tensor, ksize: int = BLUR_KSIZE) -> torch.Tensor:
    """GaussianBlur((k, k), 0) of an (H, W) uint8 image with
    BORDER_REFLECT_101, in OpenCV's fixed point: rows sum integer taps x
    pixels (8 fraction bits), columns sum taps x rows (16), then round half
    up. Integer arithmetic, so equal to OpenCV on any device."""
    taps = _gaussian_kernel_u8(ksize)
    half = ksize // 2
    H, W = u8.shape
    x = u8.to(torch.int32)
    x = x[:, _reflect101_index(W, half, u8.device)]
    rows = sum(t * x[:, i : i + W] for i, t in enumerate(taps))
    rows = rows[_reflect101_index(H, half, u8.device)]
    cols = sum(t * rows[i : i + H] for i, t in enumerate(taps))
    return ((cols + (1 << 15)) >> 16).to(torch.uint8)


def adaptive_threshold_inv(
    u8: torch.Tensor, block: int = THRESH_BLOCK, c: float = THRESH_C
) -> torch.Tensor:
    """adaptiveThreshold(255, MEAN_C, BINARY_INV, block, c): the block mean
    with BORDER_REPLICATE rounded to uint8 (no ties: block^2 is odd), then
    255 where src - mean <= -floor(c)."""
    half = block // 2
    x = F.pad(u8.to(torch.float32)[None, None], (half,) * 4, mode="replicate")[0, 0]
    x = x.to(torch.int64)
    ii = F.pad(x.cumsum(0).cumsum(1), (1, 0, 1, 0))
    H, W = u8.shape
    s = (ii[block:, block:] - ii[:H, block:] - ii[block:, :W] + ii[:H, :W])
    area = block * block
    mean = (2 * s + area) // (2 * area)
    hit = u8.to(torch.int64) - mean <= -math.floor(c)
    return hit.to(torch.uint8) * 255


def _max_filter(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Max over a kh x kw window, centred; outside the image contributes
    nothing."""
    y = F.max_pool2d(x[None, None].float(), (kh, kw), stride=1,
                     padding=(kh // 2, kw // 2))
    return y[0, 0].to(x.dtype)


def dilate_cross(bw, radius):
    return torch.maximum(_max_filter(bw, 1, 2 * radius + 1),
                         _max_filter(bw, 2 * radius + 1, 1))


def erode_cross(bw, radius):
    return 255 - dilate_cross(255 - bw, radius)


def close_cross(bw: torch.Tensor, radius: int) -> torch.Tensor:
    """morphologyEx(MORPH_CLOSE) with getStructuringElement(MORPH_CROSS,
    2r+1): dilation, then erosion; the border contributes nothing (0 to
    the dilation, 255 to the erosion)."""
    return erode_cross(dilate_cross(bw, radius), radius)


def dilate_rect(bw: torch.Tensor, radius: int) -> torch.Tensor:
    """dilate with a (2r+1) square, nothing from the border."""
    return _max_filter(bw, 2 * radius + 1, 2 * radius + 1)


# ---------------------------------------------------------------------------
# chart detection: components (host, scipy)

_EIGHT = np.ones((3, 3), bool)


def connected_components(bw: np.ndarray):
    """connectedComponentsWithStats(bw, 8) up to the label numbering
    (scipy labels in raster order of each component's first pixel):
    (n labels with the background 0, labels, areas, bbox widths, heights)."""
    labels, n = ndimage.label(bw > 0, structure=_EIGHT)
    areas = np.bincount(labels.reshape(-1), minlength=n + 1)
    widths = np.zeros(n + 1, np.int64)
    heights = np.zeros(n + 1, np.int64)
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        heights[i] = sl[0].stop - sl[0].start
        widths[i] = sl[1].stop - sl[1].start
    return n + 1, labels, areas, widths, heights


def remove_small_objects(bw: np.ndarray, min_area: float) -> np.ndarray:
    """removeSmallObjects (:728-765): every 8-connected component of fewer
    than ``min_area`` pixels set to 0."""
    _, labels, areas, _, _ = connected_components(bw)
    return np.where((areas < min_area)[labels], 0, bw).astype(np.uint8)


# ---------------------------------------------------------------------------
# chart detection: contour geometry (host)

# OpenCV's chain code directions (x right, y down): 0 east, 2 north, ...
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def _follow_border(img: bytes, step: int, x0: int, y0: int, is_hole: bool):
    """One border of a padded binary image, as OpenCV's Suzuki-Abe
    follower (icvFetchContour) walks it from its start pixel with
    CHAIN_APPROX_SIMPLE: a point wherever the chain code changes."""
    deltas = [dx + dy * step for dx, dy in zip(_DX, _DY)] * 2
    i0 = y0 * step + x0
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        return [(x0, y0)]
    pts = []
    i3, prev_s, x, y = i0, s ^ 4, x0, y0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return pts


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """findContours(RETR_TREE, CHAIN_APPROX_SIMPLE) of a mask that holds
    one 8-connected component: its outer border, then one border per
    4-connected hole, in raster order of their start pixels. Each border
    starts where OpenCV's raster scan starts it (the component's first
    pixel; the pixel left of a hole's first pixel) and is walked as
    OpenCV walks it, so the points and their order are OpenCV's.
    Returns (K, 2) int arrays of (x, y)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return []
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    # a 1-pixel zero frame around the bounding box (OpenCV pads the image)
    sub = np.zeros((y1 - y0 + 2, x1 - x0 + 2), np.uint8)
    sub[1:-1, 1:-1] = mask[y0:y1, x0:x1] != 0
    step = sub.shape[1]
    flat = sub.tobytes()
    starts = []
    fy, fx = np.unravel_index(int(np.argmax(sub)), sub.shape)
    starts.append((fy, fx, False))
    holes, n = ndimage.label(sub == 0, structure=_FOUR)
    outside = holes[0, 0]
    if n > 1:
        first = ndimage.minimum(np.arange(holes.size).reshape(holes.shape),
                                labels=holes, index=np.arange(1, n + 1))
        for lbl, idx in zip(range(1, n + 1), first):
            if lbl != outside:
                hy, hx = divmod(int(idx), step)
                starts.append((hy, hx - 1, True))
    starts.sort()
    out = []
    for sy, sx, hole in starts:
        pts = _follow_border(flat, step, sx, sy, hole)
        out.append(np.asarray(pts, np.int64) + [x0 - 1, y0 - 1])
    return out


def arc_length(pts: np.ndarray) -> float:
    """arcLength(closed=True) as OpenCV sums it: each side's length in
    float32, the closing side first, accumulated in float64."""
    p = pts.astype(np.float32)
    d = p - np.roll(p, 1, axis=0)
    lengths = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    total = 0.0
    for v in lengths.tolist():
        total += v
    return total


def approx_poly_dp(pts: np.ndarray, eps: float) -> np.ndarray:
    """approxPolyDP(closed=True) as OpenCV runs it (approxPolyDP_): three
    passes for the two farthest points (from point 0 to its farthest, from
    that to its farthest, and once more), Douglas-Peucker over the two
    arcs between them on an explicit stack, then the clean-up pass that
    drops points on near-straight runs."""
    src = [tuple(int(v) for v in p) for p in pts]
    count = len(src)
    if count == 0:
        return np.zeros((0, 2), np.int64)
    eps2 = eps * eps
    dst = []
    stack = []
    pos, rs_start = 0, 0
    start = None
    le_eps = False
    for _ in range(3):
        pos = (pos + rs_start) % count
        start = src[pos]
        pos = (pos + 1) % count
        max_dist = 0.0
        for j in range(1, count):
            pt = src[pos]
            pos = (pos + 1) % count
            dx, dy = pt[0] - start[0], pt[1] - start[1]
            dist = float(dx * dx + dy * dy)
            if dist > max_dist:
                max_dist = dist
                rs_start = j
        le_eps = max_dist <= eps2
    if not le_eps:
        s_start = pos % count
        s_end = (rs_start + s_start) % count
        stack.append((s_end, s_start))
        stack.append((s_start, s_end))
    else:
        dst.append(start)

    while stack:
        s_start, s_end = stack.pop()
        end_pt = src[s_end]
        pos = s_start
        start = src[pos]
        pos = (pos + 1) % count
        if pos != s_end:
            dx, dy = end_pt[0] - start[0], end_pt[1] - start[1]
            max_dist, split = 0.0, s_start
            while pos != s_end:
                pt = src[pos]
                pos = (pos + 1) % count
                dist = abs((pt[1] - start[1]) * dx - (pt[0] - start[0]) * dy)
                if dist > max_dist:
                    max_dist = dist
                    split = (pos + count - 1) % count
            le_eps = max_dist * max_dist <= eps2 * (dx * dx + dy * dy)
        else:
            le_eps = True
        if le_eps:
            dst.append(start)
        else:
            stack.append((split, s_end))
            stack.append((s_start, split))

    # clean-up: drop points on [almost] straight lines
    count = new_count = len(dst)
    pos = count - 1
    start = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end_pt = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end_pt[0] - start[0], end_pt[1] - start[1]
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = ((pt[0] - start[0]) * (end_pt[0] - pt[0])
                 + (pt[1] - start[1]) * (end_pt[1] - pt[1]))
        if (dist * dist <= 0.5 * eps2 * (dx * dx + dy * dy) and dx != 0 and dy != 0
                and inner >= 0):
            new_count -= 1
            dst[wpos] = start = end_pt
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    return np.asarray(dst[:new_count], np.int64).reshape(-1, 2)


def is_contour_convex(pts: np.ndarray) -> bool:
    """isContourConvex on integer points: every turn the same way, and a
    zero turn (collinear or repeated points) is not convex."""
    p = [tuple(int(v) for v in q) for q in pts]
    n = len(p)
    prev, cur = p[(n - 2) % n], p[n - 1]
    dx0, dy0 = cur[0] - prev[0], cur[1] - prev[1]
    orientation = 0
    for i in range(n):
        prev, cur = cur, p[i]
        dx, dy = cur[0] - prev[0], cur[1] - prev[1]
        a, b = dy * dx0, dx * dy0
        orientation |= 1 if a > b else (2 if a < b else 3)
        if orientation == 3:
            return False
        dx0, dy0 = dx, dy
    return True


def contour_area(pts: np.ndarray) -> float:
    """moments(contour)["m00"]: the shoelace area, positive."""
    p = pts.astype(np.float64)
    q = np.roll(p, -1, axis=0)
    return abs(float((p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]).sum()) * 0.5)


def min_area_rect(pts: np.ndarray):
    """minAreaRect of a convex quad as OpenCV computes it, in float32: the
    hull in OpenCV's order (the input order when its shoelace sum is
    positive, else reversed from the last point), rotating calipers over
    its edges keeping the last rectangle of least area, the centre as
    corner + (side1 + side2) / 2. Returns (centre (2,), the two sides),
    the sides in the order of the calipers' edges (OpenCV may list them the
    other way round; the detector reads only the shorter and longer)."""
    f = np.float32
    q = [tuple(int(v) for v in r) for r in pts]
    n = len(q)
    signed = sum(q[i][0] * q[(i + 1) % n][1] - q[(i + 1) % n][0] * q[i][1] for i in range(n))
    if signed < 0:
        q = q[::-1]
    P = [(f(x), f(y)) for x, y in q]
    vect, inv_len = [], []
    left = right = top = bottom = 0
    left_x = right_x = P[0][0]
    top_y = bottom_y = P[0][1]
    for i in range(n):
        x0, y0 = P[i]
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        x1, y1 = P[(i + 1) % n]
        dx, dy = float(x1) - float(x0), float(y1) - float(y0)
        vect.append((f(dx), f(dy)))
        inv_len.append(f(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = f(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for bx, by in vect:
        conv = ax * float(by) - ay * float(bx)
        if conv != 0:
            orientation = f(1) if conv > 0 else f(-1)
            break
        ax, ay = float(bx), float(by)
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    minarea = f(np.finfo(np.float32).max)
    buf = None
    for _ in range(n):
        v = [vect[k] for k in seq]
        dp = [base_a * v[0][0] + base_b * v[0][1],
              -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1],
              base_b * v[3][0] - base_a * v[3][1]]
        main, maxcos = 0, dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            cosalpha = dp[i] * inv_len[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        k = seq[main]
        lead_x, lead_y = vect[k][0] * inv_len[k], vect[k][1] * inv_len[k]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = P[seq[1]][0] - P[seq[3]][0], P[seq[1]][1] - P[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx, dy = P[seq[2]][0] - P[seq[0]][0], P[seq[2]][1] - P[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            buf = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = buf
    a2, b2 = -b1, a1
    c1 = a1 * P[i_left][0] + P[i_left][1] * b1
    c2 = a2 * P[i_bottom][0] + P[i_bottom][1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    s1 = (a1 * width, b1 * width)
    s2 = (a2 * height, b2 * height)
    centre = np.array([px + (s1[0] + s2[0]) * f(0.5), py + (s1[1] + s2[1]) * f(0.5)],
                      np.float64)
    w = float(f(math.sqrt(float(s1[0]) ** 2 + float(s1[1]) ** 2)))
    h = float(f(math.sqrt(float(s2[0]) ** 2 + float(s2[1]) ** 2)))
    return centre, (w, h)


def _line_pixels(p0, p1):
    """The pixels of OpenCV's 8-connected line from p0 to p1 (LineIterator,
    left to right)."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    out = []
    for _ in range(major + 1):
        out.append((x, y))
        diag = err < 0
        err += -2 * minor + (2 * major if diag else 0)
        if steep:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0
    return out


def fill_quad(pts: np.ndarray, H: int, W: int):
    """drawContours(mask, [quad], -1, 255, FILLED) on a (H, W) mask, as
    bounding-box origin and local mask: the 8-connected edge lines plus
    OpenCV's scanline fill (FillEdgeCollection: x intercepts in 16-bit
    fixed point, each row from ceil(left) to floor(right), an edge's last
    row left to its line)."""
    p = [tuple(int(v) for v in q) for q in pts]
    xs, ys = [q[0] for q in p], [q[1] for q in p]
    ox, oy = max(min(xs), 0), max(min(ys), 0)
    ex, ey = min(max(xs), W - 1), min(max(ys), H - 1)
    local = np.zeros((ey - oy + 1, ex - ox + 1), bool)

    def put(x, y):
        if ox <= x <= ex and oy <= y <= ey:
            local[y - oy, x - ox] = True

    edges = []
    for i in range(len(p)):
        a, b = p[i - 1], p[i]
        for x, y in _line_pixels(a, b):
            put(x, y)
        if a[1] == b[1]:
            continue
        (xa, ya), (xb, yb) = (a, b) if a[1] < b[1] else (b, a)
        num = (xb - xa) << 16
        den = yb - ya
        dx = abs(num) // den * (1 if num >= 0 else -1)  # C division truncates
        edges.append((ya, yb, xa << 16, dx))
    for y in range(max(min(ys), 0), min(max(ys), H)):
        xs_row = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges if y0 <= y < y1)
        for left, right in zip(xs_row[0::2], xs_row[1::2]):
            x_lo, x_hi = max((left + 0xFFFF) >> 16, 0), min(right >> 16, W - 1)
            if x_lo <= x_hi:
                local[y - oy, x_lo - ox : x_hi - ox + 1] = True
    return (oy, ox), local


def _erode3(mask: np.ndarray, border: np.ndarray) -> np.ndarray:
    """3x3 erosion of a local mask; ``border`` (top, bottom, left, right)
    says which sides lie on the image's edge, where the outside counts as
    set (erode's default border)."""
    m = np.pad(mask, 1, constant_values=False)
    if border[0]:
        m[0] = True
    if border[1]:
        m[-1] = True
    if border[2]:
        m[:, 0] = True
    if border[3]:
        m[:, -1] = True
    h, w = mask.shape
    out = np.ones_like(mask)
    for dy in range(3):
        for dx in range(3):
            out &= m[dy : dy + h, dx : dx + w]
    return out


def _dilate3(mask: np.ndarray) -> np.ndarray:
    m = np.pad(mask, 1, constant_values=False)
    h, w = mask.shape
    out = np.zeros_like(mask)
    for dy in range(3):
        for dx in range(3):
            out |= m[dy : dy + h, dx : dx + w]
    return out


def _inside(quad: np.ndarray, q: np.ndarray) -> bool:
    """Whether point q lies strictly inside the convex polygon quad."""
    p = quad.astype(np.float64)
    e = np.roll(p, -1, axis=0) - p
    cross = e[:, 0] * (q[1] - p[:, 1]) - e[:, 1] * (q[0] - p[:, 0])
    return bool(np.all(cross > 0) or np.all(cross < 0))


def _median_np(values: torch.Tensor) -> torch.Tensor:
    """np.median along dim 0 of float32 values: the mean of the two middle
    values of an even count, in float32."""
    s = torch.sort(values, dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def detect_color_chart(
    image_rgb,  # (3, H, W) float [0,1], numpy or tensor
    num_cols: int = 6,
    num_rows: int = 4,
    min_area_chart_frac: float = 5e-4,
    max_area_chart_frac: float = 0.5,
    device="cuda",
    stage_seconds: dict | None = None,
):
    """Detect MacBeth-chart patches; returns (centroids (P,2) raster order,
    rgb medians (P,3)), numpy.

    Follows detectColorChart (ColorCalibration.cpp:504-672) stage for
    stage: scale + blur -> adaptive threshold -> morphological gap fill
    (MORPH_CLOSE, cross) -> small-object removal -> dilation -> connected
    components -> per-component contours straightened with approxPolyDP
    (0.08 * arcLength) -> 4-vertex convex aspect<=2 filtering -> dropping
    quads that contain another candidate's centre (the chart's outline;
    the port's repair) -> min-distance outlier rejection
    (removeContourOutliers, :808-840) -> row-by-row sort against the
    top-left/top-right line (sortPatches, :842-917) -> per-patch median
    colour inside the eroded contour mask. The pixel stages and the
    medians run on ``device``. ``stage_seconds``, when given, receives the
    host seconds of the pixel stages (``pixel``), the components
    (``components``) and the contour geometry (``contours``)."""
    device = torch.device(device)
    clock = time.perf_counter
    t0 = clock()
    img = torch.as_tensor(image_rgb).to(device=device, dtype=torch.float32)
    H, W = img.shape[-2:]
    num_patches = num_cols * num_rows
    min_area_chart = min_area_chart_frac * H * W
    max_area_chart = max_area_chart_frac * H * W
    min_area_patch = min_area_chart / num_patches
    max_area_patch = max_area_chart / num_patches
    # morph element radius (createMorphElement, :714-726)
    radius = max(1, int(10.0 * min_area_patch / (H * W) * min(H, W)))

    bw = adaptive_threshold_inv(gaussian_blur_u8(grey_u8(img)))
    bw = close_cross(bw, radius).cpu().numpy()
    t1 = clock()
    bw = remove_small_objects(bw, 0.3 * min_area_patch)
    t2 = clock()
    bw = dilate_rect(torch.as_tensor(bw, device=device), radius).cpu().numpy()
    t3 = clock()
    n_lbl, labels, areas, widths, heights = connected_components(bw)
    t4 = clock()

    contours_all = []
    for sl, lbl in zip(ndimage.find_objects(labels), range(1, n_lbl)):
        if areas[lbl] < min_area_chart or widths[lbl] * heights[lbl] > max_area_chart:
            continue
        comp = labels[sl] == lbl
        conts = [approx_poly_dp(c, 0.08 * arc_length(c)) + [sl[1].start, sl[0].start]
                 for c in find_contours(comp)]
        # the chart body yields >= patches + 1 contours (+1 = border)
        if len(conts) >= num_patches + 1:
            contours_all.extend(conts)

    # contour filtering (:610-648): 4 vertices, convex, aspect <= 2
    patches = []
    for cont in contours_all:
        if len(cont) != 4 or not is_contour_convex(cont):
            continue
        centre, (bw_, bh_) = min_area_rect(cont)
        if min(bw_, bh_) <= 0:
            continue
        if not (min_area_patch <= contour_area(cont) <= max_area_patch):
            continue
        if max(bw_, bh_) / min(bw_, bh_) > 2.0:
            continue
        patches.append((centre, cont))
    # the repair: a quad around another candidate's centre is the chart's
    # outline, not a patch
    patches = [
        (c, q) for i, (c, q) in enumerate(patches)
        if not any(_inside(q, c2) for j, (c2, _) in enumerate(patches) if j != i)
    ]
    if len(patches) < num_patches:
        raise ValueError(f"found only {len(patches)} patch candidates, need {num_patches}")

    # removeContourOutliers (:808-840): drop patches whose nearest
    # neighbor is > 2x the median nearest-neighbor distance
    cents = np.stack([p[0] for p in patches])
    d = np.linalg.norm(cents[:, None] - cents[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    min_d = d.min(axis=1)
    # the reference's "median" = sorted[len/2] (ColorCalibration.cpp:829)
    keep = min_d < 2.0 * np.sort(min_d)[len(min_d) // 2]
    patches = [p for p, k in zip(patches, keep) if k]

    # sortPatches (:842-917): repeatedly take the num_cols centroids
    # closest to the line through the current top-left / top-right
    # patches, sort each row by x
    remaining = list(range(len(patches)))
    cents = np.stack([p[0] for p in patches])
    order = []
    while remaining:
        pts = cents[remaining]
        tl = remaining[int(np.argmin(np.linalg.norm(pts - [0, 0], axis=1)))]
        tr = remaining[int(np.argmin(np.linalg.norm(pts - [W, 0], axis=1)))]
        p1, p2 = cents[tl], cents[tr]
        seg = p2 - p1
        nrm = np.linalg.norm(seg)
        if nrm < 1e-6:
            dists = np.abs(pts[:, 1] - p1[1])
        else:
            rel = pts - p1
            dists = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / nrm
        idx = np.argsort(dists, kind="stable")[:num_cols]
        row = sorted((remaining[i] for i in idx), key=lambda i: cents[i][0])
        order.extend(row)
        remaining = [i for i in remaining if i not in row]

    # per-patch medians inside the filled quad, eroded 3x3 so the median
    # ignores boundary mixing (dilated instead below 4 pixels)
    flat = img.reshape(3, -1)
    centroids, medians = [], []
    for i in order:
        c, cont = patches[i]
        (oy, ox), local = fill_quad(cont, H, W)
        h, w = local.shape
        sel = _erode3(local, (oy == 0, oy + h == H, ox == 0, ox + w == W))
        if sel.sum() < 4:
            sel = _dilate3(sel)
        ly, lx = np.nonzero(sel)
        idx = torch.as_tensor((ly + oy) * W + (lx + ox), device=device)
        centroids.append(c)
        medians.append(_median_np(flat[:, idx].T))
    medians = torch.stack(medians).cpu().numpy()
    if stage_seconds is not None:
        t5 = clock()
        stage_seconds.update(pixel=(t1 - t0) + (t3 - t2), components=(t2 - t1) + (t4 - t3),
                             contours=t5 - t4)
    return np.asarray(centroids), medians
