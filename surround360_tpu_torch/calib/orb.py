"""ORB keypoints, steered BRIEF descriptors and Hamming matching in torch.

The port's own counterpart of what the reference's ``match_keypoints``
takes from OpenCV (``cv2.ORB_create(nfeatures=4000)``,
``BFMatcher(NORM_HAMMING).knnMatch(k=2)`` and the ratio test;
surround360_tpu/calib/matches.py:41-73), after OpenCV's ORB
(features2d/src/orb.cpp, fast.cpp): every stage runs as tensor
operations over whole images or over all keypoints of a level, on the
device of the image.

- grey: 0.299 R + 0.587 G + 0.114 B, clipped to [0, 1], times 255,
  truncated (the reference's ``to8``);
- an 8-level pyramid, each level 1/1.2 of the one before (bilinear);
- FAST-9 at threshold 20 with OpenCV's score (the largest threshold at
  which the pixel is still a corner, minus 1) and strict 3x3 non-maximum
  suppression; keypoints keep 31 px off each level's border;
- per-level quotas summing to 4000 (orb.cpp's geometric split); each
  level keeps its best 2 x quota by FAST score, then its best quota by
  the Harris response (7x7 block, k = 0.04), ties at the cut kept, as
  ``KeyPointsFilter::retainBest`` keeps them;
- orientation by the intensity centroid over the 31 px circular patch;
- 256-bit steered BRIEF on the level smoothed by a 7x7, sigma 2 Gaussian,
  at test pairs that the port learned as ORB learns its own (decorrelated
  over steered patches; ``calib/orb_pattern.py``), on procedural training
  images: not OpenCV's learned table, so descriptors and keypoints are
  not bit-equal to OpenCV's;
- matching: Hamming distances of every pair as one product of +-1
  vectors, the two nearest neighbours by ``topk``, kept when the nearest
  is below ``ratio`` times the second.

Keypoint positions are level coordinates times 1.2^level, rounded to 1/16
px: a COLMAP database keeps them as float32 and matches.json as their
shortest decimal strings, and a 1/16 px grid passes both unchanged below
4096 px, so a match graph written and read back gives the same traces.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math_util import disable_tf32

__all__ = ["to_gray8", "detect_and_compute", "match_descriptors", "orb_match"]

N_FEATURES = 4000
SCALE_FACTOR = 1.2
N_LEVELS = 8
EDGE = 31  # edgeThreshold: keypoints keep this far off the level's border
HALF_PATCH = 15  # the 31 px patch
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = 0.04
DESCRIPTOR_BITS = 256
POSITION_GRID = 16  # positions are multiples of 1/16 px

# FAST's Bresenham circle of radius 3, (dx, dy), in OpenCV's order
_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def _level_quotas(n_features: int = N_FEATURES) -> list[int]:
    """orb.cpp's split of the features over the levels: a geometric series
    of ratio 1/1.2, rounded, the last level taking the remainder."""
    factor = 1.0 / SCALE_FACTOR
    per = n_features * (1 - factor) / (1 - factor**N_LEVELS)
    quotas = []
    for _ in range(N_LEVELS - 1):
        quotas.append(int(round(per)))
        per *= factor
    quotas.append(max(n_features - sum(quotas), 0))
    return quotas


def _patch_mask() -> np.ndarray:
    """(31, 31) bool: the circular patch of the intensity centroid, rows by
    orb.cpp's u_max (symmetric by construction)."""
    h = HALF_PATCH
    vmax = int(math.floor(h * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(h * math.sqrt(2.0) / 2))
    umax = [0] * (h + 2)
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(h * h - v * v)))
    v0 = 0
    for v in range(h, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    mask = np.zeros((2 * h + 1, 2 * h + 1), bool)
    for v in range(-h, h + 1):
        d = umax[abs(v)]
        mask[v + h, h - d : h + d + 1] = True
    return mask


# the 256 tests (x1, y1, x2, y2), learned by ``calib/orb_pattern.py``
# (``python -m surround360_tpu_torch.calib.orb_pattern`` prints this table)
_PATTERN = np.array([
    ( -4, -12,  -3,  11), (  6, -13,   3,   5),
    (  0,   7,   0, -10), ( 12, -13,   3,  -1),
    (  2,  -4,   2,   2), (-10,   6,  -9,  -5),
    (-13,  -1, -10,   3), (  7,   4,   9,  -6),
    (-13, -10,  -6,   7), ( -3,  -3,  -8, -12),
    (  4,   1,   5,   3), ( -5,  -9,  -5, -10),
    (  4,  10,   3,  -5), ( 12,  12,   6,  -7),
    (  4,   6,   5,   8), (  0,   8,   0,  -5),
    (-10,  -5,  -7,   1), ( 10, -13,   6,  -9),
    ( 12,   6,  10,  -3), (-12,   0, -11,  -2),
    (-11,  -2, -13,  -3), ( -9,  12,  -4,  -5),
    ( -7,   2,  -6,   0), (  1,  -2,   3,  12),
    (  2,  -7,   4, -13), (-10, -11, -12, -12),
    (  3,  -1,   5,  -5), ( -4,   9,  -2,  -1),
    (  5,  -2,   9,   8), (  9,   7,   8,   5),
    (  4,   6,   5,  -7), ( 11,  10,   8,   8),
    ( -8,  12,  -8, -12), ( 12,  -6,  11,  -5),
    ( 12,  -3,  10,   0), (-12,   2, -10,   1),
    (-10,   9,  -5,   3), ( -7, -13,  -3,   7),
    (  7, -10,   6,   9), ( -8,  11,  -8,  12),
    ( -7,  -3,  -7,  -4), (  1,  11,   1,  -9),
    (  3,  10,   4,  12), ( -3,   4,  -5,  -9),
    (-13,   5, -12,   6), (-12,  -9, -12, -10),
    ( -3,  -2,  -3,  -3), ( 10,   3,  12,   3),
    ( -1,  -5,  -1,  -9), ( -2, -13,  -1,  -9),
    (-10,   7, -12,   8), (  9,  -8,  12,  -8),
    (  1,  10,   1,   7), (-11, -13,  -6, -10),
    (-10,  11, -12,  12), ( 11, -11,  11, -10),
    (  8,  12,  12,  12), ( -9,  -6, -13,  -7),
    ( -9,  -4, -10,  -6), (  7,  -6,  10,  -8),
    ( 11, -13,  10, -12), (  2,  -6,   2,  -5),
    (  3, -13,   2,   9), (-11,  -2,  -9,  -2),
    ( -7,   3,  -7,   4), ( 11,  -9,  11,  -8),
    ( 11,   8,  12,   7), (  9,  -1,  11,   0),
    (-13,  10, -12, -11), ( -9,  12,  -6,   9),
    ( -4,   8,  -3,   6), ( -5,  10,  -4,   9),
    (  4,   5,   4,   4), (  9,  -4,  12,  -4),
    ( -4,   9,  -4,  -7), ( 11,  11,  11, -12),
    (-13,  10, -12,  11), (  7,   4,   8,   4),
    (-13,   0, -13,   6), (  6,  -9,   6,  -7),
    ( -4, -13,  -3, -13), (  1,   3,   1,   8),
    ( -6, -12,  -4, -10), (  5,  -3,   9,  -6),
    (-13,  -2, -13,  -5), ( -1,  11,  -1,  12),
    (  8,  -3,   8,  -2), (  8,   3,   9,   2),
    (-10,   2,  -7,   1), ( 10,  -4,  11,  -2),
    (  8,   9,   8,   7), (  6,  11,   7,  12),
    (  8,   6,  10,   6), (  7,  -9,   5,   1),
    (  6,   0,   8,  -1), (  2,   1,  11,  12),
    (  0,  10,  -1, -13), (-10,  -5,  -9,  -6),
    (-11,  11,  -8,  12), ( -3, -11,  -2, -11),
    ( -8,  -2,  -5,   0), (  5,  -9,   6,  -9),
    ( -4,  -1,  -3,  -1), (  5,   3,   7,   4),
    (  9,  -7,   9,  -4), ( -9,  -6,  -9,  -8),
    (-13,   6, -13,   8), ( -3,  -2,  -2,   4),
    (  3,  11,   9, -13), (  3, -10,   6,  12),
    ( 12, -11,  11, -11), ( -2,   2,  -2, -13),
    ( -4,  -1,  -4,   0), (-12,  -8,  -9, -10),
    (  7, -12,   8, -11), (  4,   8,   5,   8),
    ( -5,  -4,  -6,  -5), (  7, -10,  10,  -9),
    ( 12,   8,  12,   2), ( -3,   5,  -2,   4),
    (  6,  12,   8,  11), ( -8,  -7,  -9, -12),
    ( 10,  12,  10,   9), (-12,  -3, -13,  -9),
    (  8, -10,  12,   5), ( -9,   5,  -8,   7),
    (  4,   2,   6,  -1), ( -8,   5,  -6,   5),
    ( -9,  -4,  -6,  -4), (  0,  10,   1,  10),
    (  5,  -2,   7,  -1), (-11,   0,  -6,   4),
    ( -3,  -6,  -3,  -4), (  6,  12,  12,  -8),
    (  6,   5,   7,   3), ( -1,  -9,   0, -10),
    ( -6, -10,  -5, -11), (-10, -10,  -7, -13),
    ( -4,   6,  -4,   4), ( -7,   7,  -6,   8),
    (-11,   2,  -9,  -9), ( -8,   1, -12, -13),
    ( -5,   7,  -4,  12), ( -8,  11, -12,  -6),
    (  6,  10,  10,   7), (  5,   6,   6,   5),
    ( -6,  -3,  -5,  -4), (  9,  12,   9,  -1),
    ( -2,   1, -12,  -8), (  2,   4,   0, -13),
    (  0,  -9,  -3,  12), (  2, -12,   4, -10),
    ( -7,  -3,  -8,  -2), ( -3,  -8,  -2,  -9),
    ( -2,  12,   0,  12), (-13,  12, -10,  -1),
    ( -1, -12,   2, -13), (  2,   5,   4,  -2),
    (  6,  -8,  11,  -4), (  1, -12,  12, -13),
    ( -5, -10,  -9, -10), (  9,   8,   4,   7),
    (  1,  -5,   5,  -8), ( -6,  -9,  -3,  -9),
    (-13,   6,  -4,  -7), ( -1,   7,   0,   7),
    (  4,  -5,   5,  -3), ( -2,  -9, -13,  12),
    ( -7,   5,  -3,   4), ( -9,  12, -10,   7),
    ( 11,  -9,   2,   4), ( -6,  11,  -7,  11),
    (  6,   0,   3,   0), ( -4,  -1,  -6,   0),
    ( 11,  -3,   5,   7), ( 12,   9,   4, -13),
    (-11,  11,   0,   1), (  3,  10,   6,   6),
    ( -4,  -3,  -2,  12), ( -8,  -7,  -4,  12),
    (  0,  10,  -1,  11), (  0,   8,   2,   6),
    (  0,  -6,   1,  -6), ( -4,   7,  -8,  -4),
    (  2,  12,   5,   9), ( -8,  -6,  -5, -10),
    (  1,  11,   4,  11), ( -7,   8,  -3, -11),
    ( -2,  -4,  -7,   6), (  7, -13,   9,   0),
    ( -4,  -9,   0,  12), ( -5,   3,  -3,   5),
    (  1,   4,   5,   7), ( -8,   2,  -4,  -8),
    (-13,  -2,  -7, -13), (  2,  11,   7,  -8),
    ( -6,  11,  -1,  11), ( -5, -12,  -6, -12),
    (  0,  -6,   9,  12), (  4,  -9,   8,   4),
    (  2,  -5,  12,   6), (-12, -11,  -1,  12),
    ( -4,   6,  -2,   6), ( -4,  -7,  -1,  -6),
    ( -3,  -4,  -2,  -5), ( -4, -13,   2,  12),
    ( -4,   9,  -6,   8), ( -3,   3,  -8,   0),
    (  0, -13,  -6,  12), (  3, -12,  -2,  12),
    ( -3, -12,   3,  -7), ( -1,   5,   1,   7),
    (-13,   1,  -5,  11), (  0,  -3,   5,   5),
    (  2,  -9,   6,  -6), (  2,  12,  -2,  -6),
    (  8, -13,  -1,   2), (  0,  -3,   2,  -4),
    ( -2,  -6,   2,  -1), (  3,   4,   1,   3),
    (  1,  -2,  -3,   4), (  4,  12,  -2,   7),
    (  6,   8,   1,  -8), ( -5, -10,   1,   7),
    ( -1,   8,   5, -11), (  1,  -5,  -6,  12),
    ( -2,   5,   3,  -8), ( -1,   9,  -8,  -9),
    (  2,   6,  12,   1), ( -5,  -5,   0,   8),
    ( -2,  -8, -13,  -5), (  0,   5,  -2,   3),
    (  4,  -9,  -1,  -9), ( -8, -13,   2,   2),
    ( -8,  -7,   0,   4), ( 10,  12,  -1, -12),
    ( -2, -10,   5,  12), ( -1,  10,   4,  -2),
    ( -1,  -2, -13,  -1), (  1, -13,  12,  -5),
    (  1, -11,  -4,   9), (  9,  -4,   1,  -4),
    (  5,   2,   2,   3), ( -2,  -7,  10, -11),
    (  1, -12,   8,   7), ( -1,  12,  12,  -9),
    ( -1, -13, -11,   8), ( -7,  -1,   0, -13),
    ( -8,  12,   3,   5), (  7, -13,  -9, -13),
    (-10,  -7,   1, -11), (  4,   4,  -2,  -9),
    (  8, -13,  -3,  11), ( 10,  -2,   1,  12),
    ( -9,  12,   4, -13), (-12,  -9,   2,  -4),
], dtype=np.int64)


def to_gray8(image, device) -> torch.Tensor:
    """(3|1, H, W) or (H, W) float in [0, 1] -> (H, W) float32 grey levels
    0..255 on ``device`` (integers, as the reference's uint8)."""
    x = torch.as_tensor(np.asarray(image), device=device).to(torch.float32)
    if x.ndim == 3:
        if x.shape[0] >= 3:
            x = 0.299 * x[0] + 0.587 * x[1] + 0.114 * x[2]
        else:
            x = x[0]
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0)


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    out = F.interpolate(img[None, None], size=(h, w), mode="bilinear",
                        align_corners=False)[0, 0]
    return torch.clamp(torch.round(out), 0.0, 255.0)


def _pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    H, W = gray.shape
    levels = [gray]
    for lvl in range(1, N_LEVELS):
        s = SCALE_FACTOR**lvl
        levels.append(_resize(levels[-1], int(round(H / s)), int(round(W / s))))
    return levels


def _shift(img: torch.Tensor, dy: int, dx: int, r: int) -> torch.Tensor:
    """img[y + dy, x + dx] over the interior y, x in [r, H - r)."""
    H, W = img.shape
    return img[r + dy : H - r + dy, r + dx : W - r + dx]


def _fast_scores(img: torch.Tensor) -> torch.Tensor:
    """(H, W) FAST-9 scores after non-maximum suppression: 0 where no
    corner survives, else OpenCV's cornerScore<16>."""
    H, W = img.shape
    center = _shift(img, 0, 0, 3)
    d = torch.stack([center - _shift(img, dy, dx, 3) for dx, dy in _CIRCLE])
    d = torch.cat([d, d[:8]]).to(torch.int16)  # 24 entries: arcs wrap

    def arc_min(x):  # min over the 9 entries of each of the 16 arcs
        m2 = torch.minimum(x[:-1], x[1:])
        m4 = torch.minimum(m2[:-2], m2[2:])
        m8 = torch.minimum(m4[:-4], m4[4:])
        return torch.minimum(m8[:16], x[8:24])

    # darker arc: min(center - c) over it; brighter: min(c - center)
    best = torch.maximum(arc_min(d).amax(0), arc_min(-d).amax(0)).to(torch.int32)
    score = torch.where(best > FAST_THRESHOLD, best - 1, torch.zeros_like(best))
    score = F.pad(score, (3, 3, 3, 3))
    # strict 3x3 non-maximum suppression (non-corners score 0)
    padded = F.pad(score, (1, 1, 1, 1))
    neigh = torch.stack([
        padded[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx
    ]).amax(0)
    return torch.where(score > neigh, score, torch.zeros_like(score))


def _retain_best(response: torch.Tensor, n: int) -> torch.Tensor:
    """Bool mask of the n largest responses, every tie at the cut kept
    (KeyPointsFilter::retainBest)."""
    if response.numel() <= n:
        return torch.ones_like(response, dtype=torch.bool)
    if n == 0:
        return torch.zeros_like(response, dtype=torch.bool)
    cut = torch.topk(response, n).values[-1]
    return response >= cut


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over the k x k block centred on each pixel (k odd), 0 outside."""
    return F.avg_pool2d(x[None, None], k, stride=1, padding=k // 2,
                        count_include_pad=True)[0, 0] * (k * k)


def _harris(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """ORB's Harris response at (ys, xs): 3x3 Sobel gradients summed over
    the 7x7 block (orb.cpp HarrisResponses), in float64."""
    g = img.to(torch.float64)
    ix = torch.zeros_like(g)
    iy = torch.zeros_like(g)
    ix[1:-1, 1:-1] = (
        (g[1:-1, 2:] - g[1:-1, :-2]) * 2
        + (g[:-2, 2:] - g[:-2, :-2])
        + (g[2:, 2:] - g[2:, :-2])
    )
    iy[1:-1, 1:-1] = (
        (g[2:, 1:-1] - g[:-2, 1:-1]) * 2
        + (g[2:, :-2] - g[:-2, :-2])
        + (g[2:, 2:] - g[:-2, 2:])
    )
    a = _box_sum(ix * ix, HARRIS_BLOCK)[ys, xs]
    b = _box_sum(iy * iy, HARRIS_BLOCK)[ys, xs]
    c = _box_sum(ix * iy, HARRIS_BLOCK)[ys, xs]
    scale = 1.0 / (4 * HARRIS_BLOCK * 255.0)
    return (a * b - c * c - HARRIS_K * (a + b) ** 2) * scale**4


def _gaussian_7x7(img: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101), rounded to levels."""
    x = torch.arange(7, dtype=torch.float64, device=img.device) - 3
    k = torch.exp(-(x * x) / (2 * 2.0**2))
    k = (k / k.sum()).to(torch.float32)
    disable_tf32()
    out = F.pad(img[None, None], (3, 3, 3, 3), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, 1, 7))
    out = F.conv2d(out, k.view(1, 1, 7, 1))[0, 0]
    return torch.round(out)


def _keypoints(img, quota, mask):
    """One pyramid level's keypoints: (ys, xs) level pixels and their
    orientation (radians) by the intensity centroid."""
    H, W = img.shape
    score = _fast_scores(img)
    score[:EDGE] = 0
    score[H - EDGE :] = 0
    score[:, :EDGE] = 0
    score[:, W - EDGE :] = 0
    ys, xs = torch.nonzero(score, as_tuple=True)
    keep = _retain_best(score[ys, xs].to(torch.float64), 2 * quota)
    ys, xs = ys[keep], xs[keep]
    keep = _retain_best(_harris(img, ys, xs), quota)
    ys, xs = ys[keep], xs[keep]
    off = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    patch = img[(ys[:, None] + off)[:, :, None], (xs[:, None] + off)[:, None, :]] * mask
    m01 = (patch.sum(2) * off.to(img.dtype)).sum(1)
    m10 = (patch.sum(1) * off.to(img.dtype)).sum(1)
    return ys, xs, torch.atan2(m01.to(torch.float64), m10.to(torch.float64))


def _describe(img, ys, xs, angle, pattern):
    """(K, 256) bool steered-BRIEF descriptors on the smoothed level: test
    i compares the pattern's two points rotated by the keypoint's angle
    (rounded to pixels, as orb.cpp's GET_VALUE)."""
    smooth = _gaussian_7x7(img)
    a, b = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    # (512,): point 1 of every test, then point 2 of every test
    px, py = pattern[:, 0::2].T.reshape(-1), pattern[:, 1::2].T.reshape(-1)
    dy = torch.round(px * b + py * a).long()
    dx = torch.round(px * a - py * b).long()
    vals = smooth[ys[:, None] + dy, xs[:, None] + dx]
    return vals[:, :DESCRIPTOR_BITS] < vals[:, DESCRIPTOR_BITS:]


def detect_and_compute(gray: torch.Tensor, n_features: int = N_FEATURES):
    """(H, W) grey levels -> ((K, 2) float64 positions (x, y) in pixels of
    the image, (K, 256) bool descriptors), on the image's device."""
    dev = gray.device
    mask = torch.as_tensor(_patch_mask(), device=dev)
    pattern = torch.as_tensor(_PATTERN, dtype=torch.float64, device=dev)
    pts, descs = [], []
    for lvl, (img, quota) in enumerate(zip(_pyramid(gray), _level_quotas(n_features))):
        if quota == 0 or min(img.shape) <= 2 * EDGE:
            continue
        ys, xs, angle = _keypoints(img, quota, mask)
        pos = torch.stack([xs, ys], 1).to(torch.float64) * (SCALE_FACTOR**lvl)
        pts.append(torch.round(pos * POSITION_GRID) / POSITION_GRID)
        descs.append(_describe(img, ys, xs, angle, pattern))
    if not pts:
        return (torch.zeros(0, 2, dtype=torch.float64, device=dev),
                torch.zeros(0, DESCRIPTOR_BITS, dtype=torch.bool, device=dev))
    return torch.cat(pts), torch.cat(descs)


def match_descriptors(desc_a, desc_b, ratio: float = 0.75):
    """Brute-force Hamming 2-NN with the ratio test: (query indices into
    a, train indices into b) of the kept matches, in query order."""
    sa = desc_a.to(torch.float32) * 2 - 1
    sb = desc_b.to(torch.float32) * 2 - 1
    dist = (DESCRIPTOR_BITS - sa @ sb.T) * 0.5  # exact small integers
    best = torch.topk(dist, 2, dim=1, largest=False)
    ok = best.values[:, 0] < ratio * best.values[:, 1]
    query = torch.nonzero(ok, as_tuple=True)[0]
    return query, best.indices[query, 0]


def orb_match(image_a, image_b, max_distance_ratio: float = 0.75, device="cuda"):
    """Detect, describe and match two images ((3|1, H, W) or (H, W) float
    in [0, 1]). Returns (pts_a (M, 2), pts_b (M, 2)) float64 numpy."""
    kp_a, desc_a = detect_and_compute(to_gray8(image_a, device))
    kp_b, desc_b = detect_and_compute(to_gray8(image_b, device))
    if len(kp_a) < 2 or len(kp_b) < 2:
        return np.zeros((0, 2)), np.zeros((0, 2))
    qa, tb = match_descriptors(desc_a, desc_b, max_distance_ratio)
    return kp_a[qa].cpu().numpy(), kp_b[tb].cpu().numpy()
