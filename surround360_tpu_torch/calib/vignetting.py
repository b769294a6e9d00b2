"""Vignetting calibration: fit separable Bezier rolloff surfaces.

Port of ``surround360_tpu/calib/vignetting.py`` (reference:
surround360_render/source/test/TestVignettingCalibration.cpp, :44-106
BezierFunctor, and TestVignettingDataAcquisition): given samples of
(pixel location, observed RGB intensity) from a uniform grey target swept
across the frame, fit per-channel separable Bezier surfaces

    vx(x / maxDim) * vy(y / maxDim) ~= intensity

then invert the fitted rolloff into the ISP's vignetteRollOffH/V gain
control points (gain = max(surface) / surface). The Ceres solve is a
small dense Levenberg-Marquardt in float64 on the device (the reference
runs it in float32); the sweep's blur and brightest-point search run on
the device too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math_util import disable_tf32, median

__all__ = ["fit_vignetting", "acquire_vignetting_samples", "VignettingFit"]

BLUR_SIGMA = 5.0  # the sweep's brightest-point blur, px
FRAMES_PER_CHUNK = 8  # sweep frames blurred at once


def _bezier_1d(ctrl, t):
    pts = [ctrl[i] for i in range(ctrl.shape[0])]
    while len(pts) > 1:
        pts = [pts[i] + t * (pts[i + 1] - pts[i]) for i in range(len(pts) - 1)]
    return pts[0]


@dataclass
class VignettingFit:
    bezier_x: np.ndarray  # (3, order+1) per channel, intensity surface
    bezier_y: np.ndarray
    rolloff_h: np.ndarray  # (order+1, 3) ISP gain control points
    rolloff_v: np.ndarray
    rms_residual: float


def fit_vignetting(
    locations: np.ndarray,  # (S, 2) pixel coords
    intensities: np.ndarray,  # (S, 3) observed RGB of the grey target
    image_size: tuple[int, int],  # (W, H)
    order: int = 4,
    iterations: int = 100,
    device="cuda",
) -> VignettingFit:
    device = torch.device(device)
    f64 = torch.float64
    W, H = image_size
    max_dim = max(W, H)
    loc = torch.as_tensor(np.asarray(locations, np.float64), device=device)
    u = loc[:, 0] / max_dim
    v = loc[:, 1] / max_dim
    obs = torch.as_tensor(np.asarray(intensities, np.float64), device=device)
    n = order + 1

    def residuals(theta):
        bx = theta[: 3 * n].reshape(3, n)
        by = theta[3 * n :].reshape(3, n)
        return torch.cat(
            [obs[:, c] - _bezier_1d(bx[c], u) * _bezier_1d(by[c], v) for c in range(3)]
        )

    jacobian = torch.func.jacfwd(residuals)

    mean0 = float(np.sqrt(np.maximum(np.mean(intensities), 1e-6)))
    theta = torch.full((6 * n,), mean0, dtype=f64, device=device)
    lam = 1e-3
    r = residuals(theta)
    cost = float(0.5 * r @ r)
    for _ in range(iterations):
        J = jacobian(theta)
        H_mat = J.T @ J
        g = J.T @ r
        damping = torch.diag(torch.clamp(torch.diagonal(H_mat), min=1e-9))
        improved = False
        for _try in range(8):
            try:
                step = torch.linalg.solve(H_mat + lam * damping, -g)
            except torch.linalg.LinAlgError:
                lam *= 10
                continue
            new_theta = theta + step
            new_r = residuals(new_theta)
            new_cost = float(0.5 * new_r @ new_r)
            if new_cost < cost:
                theta, r, cost = new_theta, new_r, new_cost
                lam = max(lam / 10, 1e-12)
                improved = True
                break
            lam *= 10
        if not improved:
            break

    bx = theta[: 3 * n].reshape(3, n)
    by = theta[3 * n :].reshape(3, n)

    # invert the intensity surface into ISP gains: the ISP multiplies by
    # curveH(x) * curveV(y); gain(t) = peak / surface(t). Bezier control
    # points are not interpolated, so fit the gain curve's control points
    # by least squares on the Bernstein basis over the used domain.
    def to_gain(ctrl, extent):
        ts = torch.linspace(0.0, extent / max_dim, 64, dtype=f64, device=device)
        basis = torch.stack(
            [math.comb(order, i) * ts**i * (1.0 - ts) ** (order - i) for i in range(n)],
            dim=1,
        )  # (64, n)
        vals = torch.stack([_bezier_1d(ctrl[c], ts) for c in range(3)], dim=1)
        gains = vals.amax(0) / torch.clamp(vals, min=1e-6)  # (64, 3)
        return torch.linalg.lstsq(basis, gains).solution  # (n, 3)

    return VignettingFit(
        bezier_x=bx.cpu().numpy(),
        bezier_y=by.cpu().numpy(),
        rolloff_h=to_gain(bx, W).cpu().numpy(),
        rolloff_v=to_gain(by, H).cpu().numpy(),
        rms_residual=float(torch.sqrt(torch.mean(r**2))),
    )


def _gaussian_kernel(sigma: float) -> torch.Tensor:
    """OpenCV's getGaussianKernel for float32 images: ksize =
    round(8 sigma + 1) | 1 taps, exp computed in double, rounded to float32,
    normalized in float32."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    total = float(np.sum(k.astype(np.float64)))
    return torch.as_tensor((k * (1.0 / total)).astype(np.float32))


def acquire_vignetting_samples(
    raw_images: list[np.ndarray],  # (H, W) demosaiced-grey or raw planes
    charts: list[tuple[float, float]] | None = None,
    patch_radius: int = 10,
    device="cuda",
):
    """Extract (location, median intensity) samples from a sweep of images
    of a grey chart (TestVignettingDataAcquisition's role). When chart
    locations aren't provided, each image's brightest point after a
    Gaussian blur of sigma 5 (OpenCV's GaussianBlur: 41 taps,
    BORDER_REFLECT_101) is used, the first maximum in raster order as
    minMaxLoc finds it. The patch is clipped at 0 on the near edges only."""
    device = torch.device(device)
    kernel = _gaussian_kernel(BLUR_SIGMA).to(device)
    half = len(kernel) // 2
    locations, intensities = [], []
    i = 0
    while i < len(raw_images):
        # up to FRAMES_PER_CHUNK consecutive frames of one size
        n = 1
        shape = np.shape(raw_images[i])
        while (n < FRAMES_PER_CHUNK and i + n < len(raw_images)
               and np.shape(raw_images[i + n]) == shape):
            n += 1
        chunk = torch.stack([
            torch.as_tensor(np.asarray(img, np.float32), device=device)
            for img in raw_images[i : i + n]
        ])
        if charts is None:
            disable_tf32()
            x = F.pad(chunk[:, None], (half, half, 0, 0), mode="reflect")
            x = F.conv2d(x, kernel.view(1, 1, 1, -1))
            x = F.pad(x, (0, 0, half, half), mode="reflect")
            x = F.conv2d(x, kernel.view(1, 1, -1, 1))
            W = x.shape[-1]
            flat = torch.argmax(x.reshape(x.shape[0], -1), dim=1)
            centers = torch.stack([flat % W, flat // W], 1).cpu().tolist()
        else:
            centers = charts[i : i + n]
        for img, (cx, cy) in zip(chunk, centers):
            x0 = int(max(cx - patch_radius, 0))
            y0 = int(max(cy - patch_radius, 0))
            med = median(img[y0 : y0 + 2 * patch_radius, x0 : x0 + 2 * patch_radius])
            locations.append([cx, cy])
            intensities.append([med, med, med])
        i += n
    return np.asarray(locations), np.asarray(intensities)
