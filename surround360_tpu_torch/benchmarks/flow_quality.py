"""Flow-quality table: pixflow_tpu against pixflow_low and no flow.

Port of ``benchmarks/flow_quality.py``, the synthetic stand-in for the
reference's Middlebury frame-interpolation RMSE harness
(TestOpticalFlow.cpp:165-226). Each scene moves a textured image by a
known transform; a flow preset's quality is the RMSE of the midpoint frame
made by warping I0 along half the estimated I1 -> I0 flow
(generateNovelViewSimpleCvRemap, NovelView.cpp:27-45) against the analytic
midpoint, 10 px of border left out.

The scenes are built with numpy and scipy, since the card's machine has no
OpenCV: ``scipy.ndimage.gaussian_filter`` (mirror borders, 4 sigma) for
``cv2.GaussianBlur`` and ``scipy.ndimage.affine_transform(order=3)`` (cubic
B-spline, zero outside) for ``cv2.warpAffine(INTER_CUBIC)`` (Keys cubic),
so they are not bit-equal to the reference's scenes: the same textures and
motions, resampled by another cubic.

    python -m surround360_tpu_torch.benchmarks.flow_quality [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["SCENES", "build_scene", "interpolation_rmse", "no_flow_rmse", "run", "main"]

SCENES = ["translation", "rotation", "zoom", "shear", "occlusion"]


def _blur(img, sigma):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma, mode="mirror", truncate=4.0).astype(np.float32)


def _texture(h, w, seed, sigma=1.5):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    # multi-scale texture: pure blurred noise lacks large-scale structure
    low = _blur(rng.random((h, w)).astype(np.float32), 8)
    return 0.6 * _blur(img, sigma) + 0.4 * low


def _rotation_matrix(cx, cy, angle_deg, scale):
    """cv2.getRotationMatrix2D: the forward 2x3 map in (x, y)."""
    a = np.deg2rad(angle_deg)
    al, be = scale * np.cos(a), scale * np.sin(a)
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]], np.float64)


def _warp_affine(img, m):
    """img resampled so that out(x, y) = img(m^-1 (x, y)), zero outside."""
    from scipy.ndimage import affine_transform

    inv = np.linalg.inv(m[:, :2])
    off = -inv @ m[:, 2]
    swap = np.array([[0, 1], [1, 0]])  # (x, y) -> (row, col)
    return affine_transform(img, swap @ inv @ swap, offset=swap @ off, order=3,
                            mode="constant", cval=0.0).astype(np.float32)


def _affine_scene(name, h=120, w=160, seed=3):
    """(i0, i1, midpoint truth) of an affine motion, mild like the motion
    between overlapping cameras."""
    big = _texture(h * 2, w * 2, seed)
    cx, cy = w, h

    def mat(t):
        if name == "translation":
            return np.array([[1, 0, 6.0 * t], [0, 1, 2.0 * t]], np.float64)
        if name == "rotation":
            return _rotation_matrix(cx, cy, 4.0 * t, 1.0)
        if name == "zoom":
            return _rotation_matrix(cx, cy, 0.0, 1.0 + 0.06 * t)
        if name == "shear":
            return np.array([[1, 0.05 * t, -0.05 * t * cy], [0, 1, 0]], np.float64)
        raise ValueError(name)

    def render(t):
        return _warp_affine(big, mat(t))[h // 2:h // 2 + h, w // 2:w // 2 + w]

    return render(0.0), render(1.0), render(0.5)


def _occlusion_scene(h=120, w=160, seed=4):
    """A foreground square moving over a background that moves the other way."""
    bg = _texture(h * 2, w * 2, seed)
    fg = _texture(h, w, seed + 1, sigma=0.8)

    def render(t):
        ox, oy = int(round(4 * t)), 0  # background +4 px in x
        frame = bg[h // 2 + oy:h // 2 + oy + h, w // 2 - ox:w // 2 - ox + w].copy()
        fx = int(round(w * 0.35 - 8 * t))  # foreground -8 px
        fy = int(round(h * 0.3))
        fh, fw = h // 3, w // 4
        frame[fy:fy + fh, fx:fx + fw] = fg[:fh, :fw] * 0.7 + 0.3
        return frame

    return render(0.0), render(1.0), render(0.5)


def build_scene(name):
    """(i0, i1, midpoint truth), each (120, 160) float32."""
    return _occlusion_scene() if name == "occlusion" else _affine_scene(name)


def interpolation_rmse(i0, i1, mid_truth, preset, device="cuda") -> float:
    """RMSE of the flow-interpolated midpoint of ``preset`` against the
    truth, 10 px of border left out; the flow runs on ``device`` (raises
    when it is CUDA and there is none)."""
    from ..cli.common import resolve_device
    from ..flow import compute_flow, make_flow_params
    from ..ops.remap import remap

    device = resolve_device(device)

    def rgba(g):
        return torch.from_numpy(np.stack([g, g, g, np.ones_like(g)], 0)[None]).to(device)

    f10 = compute_flow(rgba(i1), rgba(i0), make_flow_params(preset))
    H, W = i0.shape
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    coords = torch.from_numpy(np.stack([gx, gy])[None]).to(device) + 0.5 * f10
    mid = remap(rgba(i0)[:, :1], coords, interpolation="bicubic")
    err = mid[0, 0].cpu().numpy()[10:-10, 10:-10] - mid_truth[10:-10, 10:-10]
    return float(np.sqrt(np.mean(err * err)))


def no_flow_rmse(i0, i1, mid_truth) -> float:
    err = (0.5 * (i0 + i1) - mid_truth)[10:-10, 10:-10]
    return float(np.sqrt(np.mean(err * err)))


def run(device, scenes=None):
    """The table: per scene (scene, no-flow, pixflow_low, pixflow_tpu)
    RMSEs; printed and returned."""
    rows = []
    for scene in scenes or SCENES:
        i0, i1, mid = build_scene(scene)
        rows.append((scene, no_flow_rmse(i0, i1, mid),
                     interpolation_rmse(i0, i1, mid, "pixflow_low", device),
                     interpolation_rmse(i0, i1, mid, "pixflow_tpu", device)))
    print(f"{'scene':<12} {'no-flow':>9} {'pixflow_low':>12} {'pixflow_tpu':>12} {'tpu/low':>8}")
    for scene, base, r_low, r_tpu in rows:
        print(f"{scene:<12} {base:9.4f} {r_low:12.4f} {r_tpu:12.4f} "
              f"{r_tpu / max(r_low, 1e-9):8.2f}")
    return rows


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
