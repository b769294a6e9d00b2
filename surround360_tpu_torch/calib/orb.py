"""ORB keypoints, steered BRIEF descriptors and Hamming matching in torch.

The port's own counterpart of what the reference's ``match_keypoints``
takes from OpenCV (``cv2.ORB_create(nfeatures=4000)``,
``BFMatcher(NORM_HAMMING).knnMatch(k=2)`` and the ratio test;
surround360_tpu/calib/matches.py:32-73). It computes what OpenCV's ORB
computes (modules/features2d/src/orb.cpp, fast.cpp; imgproc's resize and
separable filter), stage for stage, as tensor operations over whole
images or over all keypoints of a level on the device of the image.
Integer arithmetic stays integer where OpenCV's is, and float32 stays
float32, one rounding an operation, so the card and the CPU give the
same keypoints and descriptors bit for bit:

- grey: cvtColor(RGB2GRAY) on float32 (``calib/color.py::grey_f32``),
  clipped to [0, 1], times 255, truncated (the reference's ``to8``);
- an 8-level pyramid: level l has ``cvRound(n * (1 / s_l))`` rows and
  columns in float32, s_l = float32(1.2 ** l), and is
  resize(INTER_LINEAR_EXACT) of level l - 1: 8-bit fixed-point weights,
  rows then columns, rounded half up from 16 fraction bits;
- FAST-9 at threshold 20 with OpenCV's score (the largest threshold at
  which the pixel is still a corner, minus 1) and strict 3x3 non-maximum
  suppression; keypoints keep 31 px off each level's border;
- per-level quotas summing to 4000 (orb.cpp's geometric split, in
  float32); each level keeps its best 2 x quota by FAST score, then its
  best quota by the Harris response (Sobel sums over the 7x7 block in
  int32, the response in float32), ties at the cut kept, as
  ``KeyPointsFilter::retainBest`` keeps them;
- orientation by the intensity centroid: integer moments over the 31 px
  circular patch, the angle by OpenCV's ``fastAtan2`` in float32 degrees;
- 256-bit steered BRIEF on the level smoothed by GaussianBlur(7x7, sigma
  2, BORDER_REFLECT_101) as OpenCV runs it on the pyramid's submatrix (its
  float path: float32 taps, rows by fused multiply-adds in tap order,
  columns by symmetric pairs, rounded half to even), at OpenCV's test
  pairs (``bit_pattern_31_``), rotated in float32 and rounded half to even;
- keypoint positions float32(level x) * s_l, as OpenCV's ``pt *= scale``;
- matching: Hamming distances of every pair as one product of +-1
  vectors, the two nearest neighbours by ``topk``, kept when the nearest
  is below ``ratio`` times the second (a tie for the nearest never is, so
  the matches do not depend on the keypoints' order).

OpenCV's keypoints come out in an order of ``std::nth_element``'s making;
the port's come level by level, row-major within a level.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math_util import disable_tf32, fma_f32
from .color import grey_f32

__all__ = ["to_gray8", "detect_and_compute", "match_descriptors", "orb_match",
           "fast_atan2", "OrbFeatures"]

N_FEATURES = 4000
SCALE_FACTOR = float(np.float32(1.2))  # ORB_create's float 1.2f, held as a double
N_LEVELS = 8
EDGE = 31  # edgeThreshold: keypoints keep this far off the level's border
HALF_PATCH = 15  # the 31 px patch
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = np.float32(0.04)
DESCRIPTOR_BITS = 256
BLUR_SIGMA = 2.0  # GaussianBlur(7x7, sigma 2)

# FAST's Bresenham circle of radius 3, (dx, dy), in OpenCV's order
_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)

# OpenCV's bit_pattern_31_ (modules/features2d/src/orb.cpp): 256 tests of
# two points each, (x1, y1, x2, y2); test i is bit i % 8 of byte i // 8.
#
# Copyright (C) 2000-2008, Intel Corporation, all rights reserved.
# Copyright (C) 2009, Willow Garage Inc., all rights reserved.
# Authors: Ethan Rublee, Vincent Rabaud, Gary Bradski.
#
# Redistribution and use in source and binary forms, with or without
# modification, are permitted provided that the following conditions are
# met:
#   * Redistribution's of source code must retain the above copyright
#     notice, this list of conditions and the following disclaimer.
#   * Redistribution's in binary form must reproduce the above copyright
#     notice, this list of conditions and the following disclaimer in the
#     documentation and/or other materials provided with the distribution.
#   * The name of the copyright holders may not be used to endorse or
#     promote products derived from this software without specific prior
#     written permission.
# This software is provided by the copyright holders and contributors "as
# is" and any express or implied warranties, including, but not limited to,
# the implied warranties of merchantability and fitness for a particular
# purpose are disclaimed. In no event shall the Intel Corporation or
# contributors be liable for any direct, indirect, incidental, special,
# exemplary, or consequential damages (including, but not limited to,
# procurement of substitute goods or services; loss of use, data, or
# profits; or business interruption) however caused and on any theory of
# liability, whether in contract, strict liability, or tort (including
# negligence or otherwise) arising in any way out of the use of this
# software, even if advised of the possibility of such damage.
BIT_PATTERN_31 = np.array([
      8,  -3,   9,   5,   4,   2,   7, -12, -11,   9,  -8,   2,   7, -12,  12, -13,
      2, -13,   2,  12,   1,  -7,   1,   6,  -2, -10,  -2,  -4, -13, -13, -11,  -8,
    -13,  -3, -12,  -9,  10,   4,  11,   9, -13,  -8,  -8,  -9, -11,   7,  -9,  12,
      7,   7,  12,   6,  -4,  -5,  -3,   0, -13,   2, -12,  -3,  -9,   0,  -7,   5,
     12,  -6,  12,  -1,  -3,   6,  -2,  12,  -6, -13,  -4,  -8,  11, -13,  12,  -8,
      4,   7,   5,   1,   5,  -3,  10,  -3,   3,  -7,   6,  12,  -8,  -7,  -6,  -2,
     -2,  11,  -1, -10, -13,  12,  -8,  10,  -7,   3,  -5,  -3,  -4,   2,  -3,   7,
    -10, -12,  -6,  11,   5, -12,   6,  -7,   5,  -6,   7,  -1,   1,   0,   4,  -5,
      9,  11,  11, -13,   4,   7,   4,  12,   2,  -1,   4,   4,  -4, -12,  -2,   7,
     -8,  -5,  -7, -10,   4,  11,   9,  12,   0,  -8,   1, -13, -13,  -2,  -8,   2,
     -3,  -2,  -2,   3,  -6,   9,  -4,  -9,   8,  12,  10,   7,   0,   9,   1,   3,
      7,  -5,  11, -10, -13,  -6, -11,   0,  10,   7,  12,   1,  -6,  -3,  -6,  12,
     10,  -9,  12,  -4, -13,   8,  -8, -12, -13,   0,  -8,  -4,   3,   3,   7,   8,
      5,   7,  10,  -7,  -1,   7,   1, -12,   3, -10,   5,   6,   2,  -4,   3, -10,
    -13,   0, -13,   5, -13,  -7, -12,  12, -13,   3, -11,   8,  -7,  12,  -4,   7,
      6, -10,  12,   8,  -9,  -1,  -7,  -6,  -2,  -5,   0,  12, -12,   5,  -7,   5,
      3, -10,   8, -13,  -7,  -7,  -4,   5,  -3,  -2,  -1,  -7,   2,   9,   5, -11,
    -11, -13,  -5, -13,  -1,   6,   0,  -1,   5,  -3,   5,   2,  -4, -13,  -4,  12,
     -9,  -6,  -9,   6, -12, -10,  -8,  -4,  10,   2,  12,  -3,   7,  12,  12,  12,
     -7, -13,  -6,   5,  -4,   9,  -3,   4,   7,  -1,  12,   2,  -7,   6,  -5,   1,
    -13,  11, -12,   5,  -3,   7,  -2,  -6,   7,  -8,  12,  -7, -13,  -7, -11, -12,
      1,  -3,  12,  12,   2,  -6,   3,   0,  -4,   3,  -2, -13,  -1, -13,   1,   9,
      7,   1,   8,  -6,   1,  -1,   3,  12,   9,   1,  12,   6,  -1,  -9,  -1,   3,
    -13, -13, -10,   5,   7,   7,  10,  12,  12,  -5,  12,   9,   6,   3,   7,  11,
      5, -13,   6,  10,   2, -12,   2,   3,   3,   8,   4,  -6,   2,   6,  12, -13,
      9, -12,  10,   3,  -8,   4,  -7,   9, -11,  12,  -4,  -6,   1,  12,   2,  -8,
      6,  -9,   7,  -4,   2,   3,   3,  -2,   6,   3,  11,   0,   3,  -3,   8,  -8,
      7,   8,   9,   3, -11,  -5,  -6,  -4, -10,  11,  -5,  10,  -5,  -8,  -3,  12,
    -10,   5,  -9,   0,   8,  -1,  12,  -6,   4,  -6,   6, -11, -10,  12,  -8,   7,
      4,  -2,   6,   7,  -2,   0,  -2,  12,  -5,  -8,  -5,   2,   7,  -6,  10,  12,
     -9, -13,  -8,  -8,  -5, -13,  -5,  -2,   8,  -8,   9, -13,  -9, -11,  -9,   0,
      1,  -8,   1,  -2,   7,  -4,   9,   1,  -2,   1,  -1,  -4,  11,  -6,  12, -11,
    -12,  -9,  -6,   4,   3,   7,   7,  12,   5,   5,  10,   8,   0,  -4,   2,   8,
     -9,  12,  -5, -13,   0,   7,   2,  12,  -1,   2,   1,   7,   5,  11,   7,  -9,
      3,   5,   6,  -8, -13,  -4,  -8,   9,  -5,   9,  -3,  -3,  -4,  -7,  -3, -12,
      6,   5,   8,   0,  -7,   6,  -6,  12, -13,   6,  -5,  -2,   1, -10,   3,  10,
      4,   1,   8,  -4,  -2,  -2,   2, -13,   2, -12,  12,  12,  -2, -13,   0,  -6,
      4,   1,   9,   3,  -6, -10,  -3,  -5,  -3, -13,  -1,   1,   7,   5,  12, -11,
      4,  -2,   5,  -7, -13,   9,  -9,  -5,   7,   1,   8,   6,   7,  -8,   7,   6,
     -7,  -4,  -7,   1,  -8,  11,  -7,  -8, -13,   6, -12,  -8,   2,   4,   3,   9,
     10,  -5,  12,   3,  -6,  -5,  -6,   7,   8,  -3,   9,  -8,   2, -12,   2,   8,
    -11,  -2, -10,   3, -12, -13,  -7,  -9, -11,   0, -10,  -5,   5,  -3,  11,   8,
     -2, -13,  -1,  12,  -1,  -8,   0,   9, -13, -11, -12,  -5, -10,  -2, -10,  11,
     -3,   9,  -2, -13,   2,  -3,   3,   2,  -9, -13,  -4,   0,  -4,   6,  -3, -10,
     -4,  12,  -2,  -7,  -6, -11,  -4,   9,   6,  -3,   6,  11, -13,  11,  -5,   5,
     11,  11,  12,   6,   7,  -5,  12,  -2,  -1,  12,   0,   7,  -4,  -8,  -3,  -2,
     -7,   1,  -6,   7, -13, -12,  -8, -13,  -7,  -2,  -6,  -8,  -8,   5,  -6,  -9,
     -5,  -1,  -4,   5, -13,   7,  -8,  10,   1,   5,   5, -13,   1,   0,  10, -13,
      9,  12,  10,  -1,   5,  -8,  10,  -9,  -1,  11,   1, -13,  -9,  -3,  -6,   2,
     -1, -10,   1,  12, -13,   1,  -8, -10,   8, -11,  10,  -6,   2, -13,   3,  -6,
      7, -13,  12,  -9, -10, -10,  -5,  -7, -10,  -8,  -8, -13,   4,  -6,   8,   5,
      3,  12,   8, -13,  -4,   2,  -3,  -3,   5, -13,  10, -12,   4, -13,   5,  -1,
     -9,   9,  -4,   3,   0,   3,   3,  -9, -12,   1,  -6,   1,   3,   2,   4,  -8,
    -10, -10, -10,   9,   8, -13,  12,  12,  -8, -12,  -6,  -5,   2,   2,   3,   7,
     10,   6,  11,  -8,   6,   8,   8, -12,  -7,  10,  -6,   5,  -3,  -9,  -3,   9,
     -1, -13,  -1,   5,  -3,  -7,  -3,   4,  -8,  -2,  -8,   3,   4,   2,  12,  12,
      2,  -5,   3,  11,   6,  -9,  11, -13,   3,  -1,   7,  12,  11,  -1,  12,   4,
     -3,   0,  -3,   6,   4, -11,   4,  12,   2,  -4,   2,   1, -10,  -6,  -8,   1,
    -13,   7, -11,   1, -13,  12, -11, -13,   6,   0,  11, -13,   0,  -1,   1,   4,
    -13,   3,  -9,  -2,  -9,   8,  -6,  -3, -13,  -6,  -8,  -2,   5,  -9,   8,  10,
      2,   7,   3,  -9,  -1,  -6,  -1,  -1,   9,   5,  11,  -2,  11,  -3,  12,  -8,
      3,   0,   3,   5,  -1,   4,   0,  10,   3,  -6,   4,   5, -13,   0, -10,   5,
      5,   8,  12,  11,   8,   9,   9,  -6,   7,  -4,   8, -12, -10,   4, -10,   9,
      7,   3,  12,   4,   9,  -7,  10,  -2,   7,   0,  12,  -2,  -1,  -6,   0, -11,
], dtype=np.int32).reshape(DESCRIPTOR_BITS, 4)


class OrbFeatures(NamedTuple):
    points: torch.Tensor  # (K, 2) float32 (x, y) in pixels of the image
    descriptors: torch.Tensor  # (K, 256) bool, test i in column i
    octaves: torch.Tensor  # (K,) int64 pyramid level of each keypoint


def to_gray8(image, device) -> torch.Tensor:
    """(3|1, H, W) or (H, W) float in [0, 1] -> (H, W) uint8 on ``device``,
    as the reference's ``to8``: RGB through cvtColor's float32 grey, one
    channel as it is; clip(0, 1) * 255 in that dtype, truncated."""
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[:3] if arr.shape[0] >= 3 else arr[0]  # only what is read goes to the card
    x = torch.as_tensor(arr, device=device)
    if x.ndim == 3:
        x = grey_f32(x)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _level_quotas(n_features: int = N_FEATURES) -> list[int]:
    """orb.cpp's split of the features over the levels, in float32: a
    geometric series of ratio 1/1.2, rounded half to even, the last level
    taking the remainder."""
    f32 = np.float32
    factor = f32(1.0 / SCALE_FACTOR)
    per = f32(n_features) * (f32(1) - factor) / (
        f32(1) - f32(math.pow(float(factor), N_LEVELS)))
    quotas = []
    for _ in range(N_LEVELS - 1):
        quotas.append(int(np.rint(per)))
        per = f32(per * factor)
    quotas.append(max(n_features - sum(quotas), 0))
    return quotas


def _level_scale(level: int) -> np.float32:
    """orb.cpp's getScale: float32(pow(double(1.2f), level))."""
    return np.float32(math.pow(SCALE_FACTOR, level))


def _level_sizes(H: int, W: int) -> list[tuple[int, int]]:
    """(rows, cols) of every level: cvRound(n * (1.0f / scale)) in float32."""
    sizes = []
    for level in range(N_LEVELS):
        inv = np.float32(1) / _level_scale(level)
        sizes.append((int(np.rint(np.float32(H) * inv)), int(np.rint(np.float32(W) * inv))))
    return sizes


def _linear_exact_taps(src: int, dst: int, device):
    """resize(INTER_LINEAR_EXACT)'s taps along one axis (imgproc's
    interpolationLinear, in IEEE double as its softdouble): source index
    and weight of the two taps of each output, weights in 1/256 (int32).
    Outputs left or right of the source take its edge pixel at weight 256."""
    scale = 1.0 / (dst / src)
    f = scale * (torch.arange(dst, dtype=torch.float64, device=device) + 0.5) - 0.5
    i = torch.floor(f)
    w1 = torch.round((f - i) * 256).to(torch.int32)
    i = i.long()
    w1 = torch.where((i >= 0) & (i < src - 1), w1, 0)
    i0 = i.clamp(0, src - 1)
    return i0, (i0 + 1).clamp(max=src - 1), 256 - w1, w1


def _resize_linear_exact(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W) uint8 -> (h, w) uint8 as resize(INTER_LINEAR_EXACT): each row
    resampled to 8 fraction bits, then the columns to 16, rounded half up."""
    H, W = img.shape
    x0, x1, a0, a1 = _linear_exact_taps(W, w, img.device)
    y0, y1, b0, b1 = _linear_exact_taps(H, h, img.device)
    x = img.to(torch.int32)
    rows = x[:, x0] * a0 + x[:, x1] * a1
    out = rows[y0] * b0[:, None] + rows[y1] * b1[:, None]
    return ((out + (1 << 15)) >> 16).to(torch.uint8)


def _pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    sizes = _level_sizes(*gray.shape)
    levels = [gray]
    for h, w in sizes[1:]:
        levels.append(_resize_linear_exact(levels[-1], h, w))
    return levels


def _shift(img: torch.Tensor, dy: int, dx: int, r: int) -> torch.Tensor:
    """img[y + dy, x + dx] over the interior y, x in [r, H - r)."""
    H, W = img.shape
    return img[r + dy : H - r + dy, r + dx : W - r + dx]


def _fast_scores(img: torch.Tensor) -> torch.Tensor:
    """(H, W) FAST-9 scores of a uint8 level after non-maximum
    suppression: 0 where no corner survives, else OpenCV's cornerScore<16>."""
    H, W = img.shape
    img = img.to(torch.int16)
    center = _shift(img, 0, 0, 3)
    d = torch.stack([center - _shift(img, dy, dx, 3) for dx, dy in _CIRCLE])
    d = torch.cat([d, d[:8]])  # 24 entries: arcs wrap

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


def _block(ys, xs, r: int, device):
    """(K, (2r+1)^2) row and column indices of the square of radius r
    around each (ys, xs), rows outer."""
    off = torch.arange(-r, r + 1, device=device)
    by = (ys[:, None] + off)[:, :, None].expand(-1, -1, 2 * r + 1)
    bx = (xs[:, None] + off)[:, None, :].expand(-1, 2 * r + 1, -1)
    n = (2 * r + 1) ** 2
    return by.reshape(len(ys), n), bx.reshape(len(xs), n)


def _harris(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """ORB's Harris response at (ys, xs) (orb.cpp HarrisResponses): 3x3
    Sobel gradients summed over the 7x7 block in int32, then
    ``((float)a*b - (float)c*c - k*((float)a+b)^2) * scale^4`` in float32."""
    g = img.to(torch.int32)
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
    by, bx = _block(ys, xs, HARRIS_BLOCK // 2, img.device)
    gx, gy = ix[by, bx], iy[by, bx]
    a = (gx * gx).sum(1, dtype=torch.int32).float()
    b = (gy * gy).sum(1, dtype=torch.int32).float()
    c = (gx * gy).sum(1, dtype=torch.int32).float()
    f32 = np.float32
    scale = f32(1) / (f32(4 * HARRIS_BLOCK) * f32(255))
    scale4 = f32(f32(f32(scale * scale) * scale) * scale)
    s = a + b
    return ((a * b - c * c) - (torch.tensor(HARRIS_K) * s) * s) * torch.tensor(scale4)


def _patch_mask() -> np.ndarray:
    """(31, 31) bool: the circular patch of the intensity centroid, rows by
    orb.cpp's u_max (in its float32 and double arithmetic; symmetric by
    construction)."""
    h = HALF_PATCH
    sqrt2 = float(np.float32(math.sqrt(2.0)))
    vmax = int(math.floor(float(np.float32(h * sqrt2 / 2 + 1))))
    vmin = int(math.ceil(float(np.float32(h * sqrt2 / 2))))
    umax = [0] * (h + 2)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(h * h - v * v)))
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


_F32 = np.float32
_RAD_TO_DEG = _F32(180 / math.pi)
# fastAtan2's polynomial, its coefficients float32 products as OpenCV's
# (core's mathfuncs: atan2_p1 = 0.9997878412794807f * (float)(180 / CV_PI))
_ATAN_P = tuple(_F32(_F32(p) * _RAD_TO_DEG) for p in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128))
_DBL_EPSILON = _F32(np.finfo(np.float64).eps)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's fastAtan2 on float32 tensors: degrees in [0, 360), its 7th
    order polynomial of min / (max + DBL_EPSILON), folded by octant and
    quadrant, one float32 rounding an operation."""
    p1, p3, p5, p7 = (torch.tensor(p) for p in _ATAN_P)
    y, x = y.float(), x.float()
    ax, ay = x.abs(), y.abs()
    steep = ax < ay
    c = torch.where(steep, ax, ay) / (torch.where(steep, ay, ax) + torch.tensor(_DBL_EPSILON))
    c2 = c * c
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(steep, 90.0 - a, a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _angles(img: torch.Tensor, ys, xs, mask: torch.Tensor) -> torch.Tensor:
    """(K,) float32 degrees: the intensity centroid's angle (orb.cpp
    ICAngles), integer moments over the circular patch."""
    by, bx = _block(ys, xs, HALF_PATCH, img.device)
    side = 2 * HALF_PATCH + 1
    patch = img.to(torch.int32)[by, bx].view(len(ys), side, side) * mask
    off = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device, dtype=torch.int32)
    m01 = (patch.sum(2, dtype=torch.int32) * off).sum(1, dtype=torch.int32)
    m10 = (patch.sum(1, dtype=torch.int32) * off).sum(1, dtype=torch.int32)
    return fast_atan2(m01.float(), m10.float())


def _gaussian_taps() -> torch.Tensor:
    """getGaussianKernel(7, 2, CV_32F): exp(-x^2 / (2 sigma^2)) in double,
    normalised to sum 1, cast to float32."""
    scale2 = -0.5 / (BLUR_SIGMA * BLUR_SIGMA)
    vals = [math.exp(float(x * x) * scale2) for x in range(-3, 0)]
    total = 2.0 * sum(vals) + 1.0
    taps = [v / total for v in vals]
    return torch.tensor(taps + [1.0 / total] + taps[::-1], dtype=torch.float32)


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _blur(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101) of a uint8 level as
    ORB runs it, in place on its pyramid's submatrix: OpenCV's float path
    (sepFilter2D): each row a fused multiply-add a tap, in tap order; each
    column the centre tap's product, then a fused multiply-add of each
    symmetric pair's sum (nearest pair first); rounded half to even.
    ``k``: :func:`_gaussian_taps` on the image's device."""
    H, W = img.shape
    # the rows' fused multiply-adds are exact sums in float64 rounded once:
    # a pixel is an integer below 2^8 and a tap a float32 above 2^-4, so
    # every float32 partial sum is a multiple of 2^-27 below 2^9
    x = img[:, _reflect101(W, 3, img.device)].double()
    k64 = k.double()
    rows = (x[:, 0:W] * k64[0]).float()
    for i in range(1, 7):
        rows = (x[:, i : i + W] * k64[i] + rows.double()).float()
    rows = rows[_reflect101(H, 3, img.device)]
    out = rows[3 : 3 + H] * k[3]
    for i in range(1, 4):
        out = fma_f32(rows[3 - i : 3 - i + H] + rows[3 + i : 3 + i + H], k[3 + i], out)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


_DEG_TO_RAD = _F32(math.pi / 180.0)  # orb.cpp: (float)(CV_PI / 180.f)


def _describe(img, ys, xs, angle, pattern, taps):
    """(K, 256) bool steered-BRIEF descriptors on the smoothed level
    (orb.cpp computeOrbDescriptors): test i rotates its two points by the
    keypoint's angle in float32 (x a - y b, x b + y a; a and b the float32
    cosine and sine), rounds them half to even and compares the two pixels."""
    smooth = _blur(img, taps)
    rad = angle * torch.tensor(_DEG_TO_RAD)
    a = torch.cos(rad.double()).float()[:, None]
    b = torch.sin(rad.double()).float()[:, None]
    # (512,): point 1 of every test, then point 2 of every test
    px = torch.cat([pattern[:, 0], pattern[:, 2]])
    py = torch.cat([pattern[:, 1], pattern[:, 3]])
    dx = torch.round(px * a - py * b).long()
    dy = torch.round(px * b + py * a).long()
    vals = smooth[ys[:, None] + dy, xs[:, None] + dx]
    return vals[:, :DESCRIPTOR_BITS] < vals[:, DESCRIPTOR_BITS:]


def detect_and_compute(gray: torch.Tensor, n_features: int = N_FEATURES) -> OrbFeatures:
    """(H, W) uint8 grey levels -> :class:`OrbFeatures` (float32 positions,
    descriptors, levels), on the image's device: OpenCV's ORB at
    ``nfeatures=n_features``, level by level."""
    dev = gray.device
    mask = torch.as_tensor(_patch_mask(), device=dev)
    pattern = torch.as_tensor(BIT_PATTERN_31, dtype=torch.float32, device=dev)
    taps = _gaussian_taps().to(dev)
    pts, descs, octaves = [], [], []
    for lvl, (img, quota) in enumerate(zip(_pyramid(gray), _level_quotas(n_features))):
        H, W = img.shape
        if quota == 0 or H <= 2 * EDGE or W <= 2 * EDGE:
            continue
        score = _fast_scores(img)[EDGE : H - EDGE, EDGE : W - EDGE]
        ys, xs = torch.nonzero(score, as_tuple=True)
        keep = _retain_best(score[ys, xs].float(), 2 * quota)
        ys, xs = ys[keep] + EDGE, xs[keep] + EDGE
        if len(ys) == 0:
            continue
        keep = _retain_best(_harris(img, ys, xs), quota)
        ys, xs = ys[keep], xs[keep]
        angle = _angles(img, ys, xs, mask)
        pos = torch.stack([xs, ys], 1).float() * torch.tensor(_level_scale(lvl))
        pts.append(pos)
        descs.append(_describe(img, ys, xs, angle, pattern, taps))
        octaves.append(torch.full_like(ys, lvl))
    if not pts:
        return OrbFeatures(torch.zeros(0, 2, device=dev),
                           torch.zeros(0, DESCRIPTOR_BITS, dtype=torch.bool, device=dev),
                           torch.zeros(0, dtype=torch.int64, device=dev))
    return OrbFeatures(torch.cat(pts), torch.cat(descs), torch.cat(octaves))


def match_descriptors(desc_a, desc_b, ratio: float = 0.75):
    """Brute-force Hamming 2-NN with the ratio test (the nearest distance
    below ``ratio`` times the second, compared in float64 as the
    reference's Python compares them): (query indices into a, train
    indices into b) of the kept matches, in query order."""
    disable_tf32()
    sa = desc_a.to(torch.float32) * 2 - 1
    sb = desc_b.to(torch.float32) * 2 - 1
    dist = (DESCRIPTOR_BITS - sa @ sb.T) * 0.5  # exact small integers
    best = torch.topk(dist, 2, dim=1, largest=False)
    d = best.values.double()
    ok = d[:, 0] < ratio * d[:, 1]
    query = torch.nonzero(ok, as_tuple=True)[0]
    return query, best.indices[query, 0]


def orb_match(image_a, image_b, max_distance_ratio: float = 0.75, device="cuda"):
    """Detect, describe and match two images ((3|1, H, W) or (H, W) float
    in [0, 1]). Returns (pts_a (M, 2), pts_b (M, 2)) float64 numpy: the
    float32 positions of the matched keypoints, as OpenCV's ``kp.pt``."""
    kp_a, desc_a, _ = detect_and_compute(to_gray8(image_a, device))
    kp_b, desc_b, _ = detect_and_compute(to_gray8(image_b, device))
    if len(kp_a) < 2 or len(kp_b) < 2:
        return np.zeros((0, 2)), np.zeros((0, 2))
    qa, tb = match_descriptors(desc_a, desc_b, max_distance_ratio)
    return kp_a[qa].double().cpu().numpy(), kp_b[tb].double().cpu().numpy()
