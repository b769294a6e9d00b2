"""Capture simulator: synthesize rig camera images from a virtual scene.

Port of ``surround360_tpu/capture/simulator.py``: an analytic environment
(color as a function of view direction) rendered through the exact camera
model (host float64 numpy), giving both the renderer's input views and the
analytic ground-truth equirect. Nothing is cached on disk.
"""

from __future__ import annotations

import numpy as np

from ..geometry import camera as cam_mod
from ..geometry.rig import Rig

__all__ = [
    "checker_sinusoid_environment",
    "render_camera_views",
    "render_equirect_reference",
]


def checker_sinusoid_environment(direction, sharpness: float = 6.0):
    """RGB as sinusoids of the view direction. direction (..., 3) unit
    vectors -> (..., 3) float32."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    r = 0.5 + 0.25 * np.sin(sharpness * x) + 0.25 * np.cos(sharpness * y * 0.7)
    g = 0.5 + 0.25 * np.sin(sharpness * 0.8 * y + 1.0) + 0.25 * np.sin(
        sharpness * 0.5 * z
    )
    b = 0.5 + 0.25 * np.cos(sharpness * 0.6 * x + 2.0) + 0.25 * np.sin(
        sharpness * 0.9 * z + 1.0
    )
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def render_camera_views(
    rig: Rig,
    env_fn=checker_sinusoid_environment,
    scene_distance: float = 1.0e6,
    image_size: int | None = None,
):
    """Every rig camera's RGBA view of the environment sphere of radius
    ``scene_distance`` (cm). Returns a list of (4, H, W) float32 numpy
    arrays in rig camera order; fisheyes get alpha=0 outside their fov."""
    views = []
    for cam in rig.cameras:
        res = np.asarray(cam.resolution, dtype=np.int64)
        W, H = int(res[0]), int(res[1])
        if image_size is not None:
            cam = cam_mod.create_rescaled_camera(cam, image_size / max(W, H))
            res = np.asarray(cam.resolution, dtype=np.int64)
            W, H = int(res[0]), int(res[1])
        xs = np.arange(W, dtype=np.float64)
        ys = np.arange(H, dtype=np.float64)
        gx, gy = np.meshgrid(xs, ys)
        pix = np.stack([gx, gy], axis=-1)
        direction = cam_mod.pixel_to_rig_direction(cam, pix)
        origin = np.asarray(cam.position, dtype=np.float64)
        b = np.sum(direction * origin, axis=-1)
        c = np.sum(origin * origin) - scene_distance**2
        t_hit = -b + np.sqrt(np.maximum(b * b - c, 0.0))
        hit = origin + t_hit[..., None] * direction
        hit_dir = hit / np.linalg.norm(hit, axis=-1, keepdims=True)
        rgb = env_fn(hit_dir)
        world = origin + direction * 10.0  # fov test point along the ray
        alpha = (~np.asarray(cam_mod.is_outside_fov(cam, world))).astype(
            np.float32
        )
        rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
        views.append(np.moveaxis(rgba, -1, 0).astype(np.float32))
    return views


def render_equirect_reference(
    ctx,
    env_fn=checker_sinusoid_environment,
    after_wrap_shift: bool = True,
    full_sphere: bool = False,
):
    """Ground-truth mono equirect (3, eqr_h, eqr_w) float32 for an
    at-infinity environment, in the renderer's output layout (chunk
    geometry, zero-parallax wrap shift, the side strip's phi sweep; with
    ``full_sphere`` the sweep continues into the polar caps)."""
    cfg = ctx.config
    n = ctx.num_side_cams
    Wc = ctx.chunk_w
    eqr_w, eqr_h = cfg.eqr_width, cfg.eqr_height

    x = np.arange(eqr_w, dtype=np.float64)
    if after_wrap_shift:
        x = x - ctx.zero_parallax_shift_px
    i = np.floor(x / Wc)
    nv = x - i * Wc
    verge = float(ctx.warp_cols_l[0] - (ctx.strip_w / 2.0 - Wc))
    strip_offset = ctx.strip_w - ctx.overlap_w - Wc
    theta = (
        -2.0 * np.pi * i / n
        - (strip_offset + nv + verge + 0.5) * ctx.h_radians / ctx.strip_w
    )

    pad_above = (eqr_h - ctx.strip_h) // 2
    y = np.arange(eqr_h, dtype=np.float64)
    phi = ctx.v_radians / 2.0 - (y - pad_above + 0.5) * (
        ctx.v_radians / ctx.strip_h
    )
    if full_sphere:
        phi = np.clip(phi, -np.pi / 2.0, np.pi / 2.0)

    ph, th = np.meshgrid(phi, theta, indexing="ij")
    unit = np.stack(
        [np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th), np.sin(ph)],
        axis=-1,
    )
    rgb = env_fn(unit)
    if not full_sphere:
        valid = (y >= pad_above) & (y < pad_above + ctx.strip_h)
        rgb = rgb * valid[:, None, None]
    return np.moveaxis(rgb, -1, 0).astype(np.float32)
