"""Warp fields: camera <-> equirect strips and equirect -> cubemap faces
(host float64 numpy).

Port of the renderer's part of ``surround360_tpu/ops/warp.py`` (reference:
surround360_render/source/render/ImageWarper.{h,cpp}). Warp fields are
(2, H, W) float32 coords (x, y) in source pixel units, integer = pixel
center (the reference's ``pixel - 0.5`` correction, ImageWarper.cpp:166).
"""

from __future__ import annotations

import numpy as np

from . import camera as cam_mod
from .camera import Camera

__all__ = [
    "approximate_fov",
    "rig_fov",
    "spherical_warp_for_camera",
    "side_cam_spherical_warp",
    "equirect_to_cam_warp",
    "CUBEMAP_FACE_ORDER",
    "equirect_to_cubemap_warp",
]


def approximate_fov(cam: Camera, vertical: bool) -> float:
    """Angle from forward to the principal row/column edge rays
    (TestRenderStereoPanorama.cpp:75-88)."""
    principal = np.asarray(cam.principal, dtype=np.float64)
    a = principal.copy()
    b = principal.copy()
    res = np.asarray(cam.resolution, dtype=np.float64)
    if vertical:
        a[1] = 0.0
        b[1] = res[1]
    else:
        a[0] = 0.0
        b[0] = res[0]
    fwd = np.asarray(cam.forward, dtype=np.float64)
    da = cam_mod.pixel_to_rig_direction(cam, a)
    db = cam_mod.pixel_to_rig_direction(cam, b)
    return float(np.arccos(max(np.dot(da, fwd), np.dot(db, fwd))))


def rig_fov(cams: list[Camera], vertical: bool) -> float:
    """Max approximate fov over cameras (TestRenderStereoPanorama.cpp:91-97)."""
    return max(approximate_fov(c, vertical) for c in cams)


def spherical_warp_for_camera(
    cam: Camera,
    out_hw: tuple[int, int],
    left_angle: float,
    right_angle: float,
    top_angle: float,
    bottom_angle: float,
) -> np.ndarray:
    """Equirect-strip -> camera warp field (2, H, W) float32
    (bicubicRemapToSpherical, ImageWarper.cpp:143-174)."""
    H, W = out_hw
    xfrac = (np.arange(W, dtype=np.float64) + 0.5) / W
    yfrac = (np.arange(H, dtype=np.float64) + 0.5) / H
    x_angle = (1.0 - xfrac) * left_angle + xfrac * right_angle
    y_angle = (1.0 - yfrac) * top_angle + yfrac * bottom_angle
    ya, xa = np.meshgrid(y_angle, x_angle, indexing="ij")
    unit = np.stack(
        [np.cos(ya) * np.cos(xa), np.cos(ya) * np.sin(xa), np.sin(ya)], axis=-1
    )
    pix = cam_mod.world_to_pixel(cam, unit * cam_mod.NEAR_INFINITY)
    coords = np.moveaxis(pix, -1, 0) - 0.5
    return coords.astype(np.float32)


def side_cam_spherical_warp(
    cam: Camera,
    cam_index: int,
    num_cams: int,
    eqr_wh: tuple[int, int],
    h_radians: float,
    v_radians: float,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Warp + strip size for one side camera's spherical projection
    (projectSphericalCamImages, TestRenderStereoPanorama.cpp:138-175)."""
    eqr_w, eqr_h = eqr_wh
    strip_h = int(eqr_h * v_radians / np.pi)
    strip_w = int(eqr_w * h_radians / (2.0 * np.pi))
    direction = -float(cam_index) / num_cams * 2.0 * np.pi
    warp = spherical_warp_for_camera(
        cam,
        (strip_h, strip_w),
        direction + h_radians / 2.0,
        direction - h_radians / 2.0,
        v_radians / 2.0,
        -v_radians / 2.0,
    )
    return warp, (strip_h, strip_w)


def equirect_to_cam_warp(
    cam: Camera,
    eqr_hw: tuple[int, int],
    depth: float,
) -> np.ndarray:
    """Full-equirect -> camera warp (2, H, W): theta = 2 pi x / W,
    phi = pi y / H measured from +z; unseen pixels get (-1, -1) so remap's
    constant border yields transparent samples (projectEquirectToCam,
    ImageWarper.cpp:179-196)."""
    H, W = eqr_hw
    theta = (np.arange(W, dtype=np.float64) + 0.5) * (2.0 * np.pi / W)
    phi = (np.arange(H, dtype=np.float64) + 0.5) * (np.pi / H)
    ph, th = np.meshgrid(phi, theta, indexing="ij")
    direction = np.stack(
        [np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th), np.cos(ph)], axis=-1
    )
    world = direction * depth
    pix = cam_mod.world_to_pixel(cam, world)
    visible = cam_mod.sees(cam, world)
    coords = np.where(visible[None], np.moveaxis(pix, -1, 0) - 0.5, -1.0)
    return coords.astype(np.float32)


# face order matches convertSphericalToCubemapBicubicRemap
# (ImageWarper.cpp:101-108)
CUBEMAP_FACE_ORDER = ("right", "left", "top", "bottom", "back", "front")


def _cubemap_dir(x, y, face: str):
    """Face-local (x, y, 0.5) -> direction (ImageWarper.cpp:26-63)."""
    half = np.full_like(x, 0.5)
    if face == "back":
        return x, half, -y
    if face == "left":
        return -half, x, -y
    if face == "top":
        return x, y, half
    if face == "bottom":
        return x, -y, -half
    if face == "front":
        return -x, -half, -y
    if face == "right":
        return half, -x, -y
    raise ValueError(face)


def equirect_to_cubemap_warp(
    eqr_hw: tuple[int, int],
    face_wh: tuple[int, int],
    face: str,
    fisheye_fov_radians: float = np.pi,
) -> np.ndarray:
    """Warp (2, faceH, faceW) sampling an equirect image into one cubemap
    face (mapEquirectToCubemapCoordinate, ImageWarper.cpp:65-93). Use with
    border='wrap' like the reference's BORDER_WRAP remap."""
    eqr_h, eqr_w = eqr_hw
    face_w, face_h = face_wh
    xs = np.arange(face_w, dtype=np.float64) / face_w - 0.5
    ys = np.arange(face_h, dtype=np.float64) / face_h - 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    dx, dy, dz = _cubemap_dir(xx, yy, face)
    norm = np.sqrt(dx * dx + dy * dy + dz * dz)
    phi = np.arccos(np.clip(dz / norm, -1.0, 1.0))
    theta = np.arctan2(dy, dx)  # quadrant-correct form of ImageWarper.cpp:77-87
    theta = np.where(theta < 0, theta + 2.0 * np.pi, theta)
    phi_p = np.clip(phi, 0.0, fisheye_fov_radians)
    theta_p = np.clip(theta, 0.0, 2.0 * np.pi)
    src_x = eqr_w * theta_p / (2.0 * np.pi)
    src_y = eqr_h * phi_p / fisheye_fov_radians
    return np.stack([src_x, src_y], axis=0).astype(np.float32)
