"""FTHETA/RECTILINEAR camera model on the host (float64 numpy).

Port of ``surround360_tpu/geometry/camera.py`` (reference:
surround360_render/source/render/Camera.{h,cpp}; format spec RIG_JSON.md).
The reference module is array-module polymorphic so the same code can be
traced by JAX; in this package every caller of the camera model is host
precompute (rig-static warps, the capture simulator), so it is numpy only.
The arithmetic is written in the same order as the reference so the
float64 warp tables come out bit-identical.

- pose: position (cm, rig frame) + row-major rotation whose rows are
  (right, up, backward); +z is behind the camera (Camera.cpp:16-29).
- projection ``world_to_pixel``: rig -> camera -> distorted sensor ->
  pixel (Camera.h:133-140); FTHETA uses r = distort(atan2(|xy|, -z)),
  RECTILINEAR projects on z=-1 and scales by the distortion factor.
- distortion: distort(r) = r + d0 r^3 + d1 r^5 (Camera.h:219-227); inverse
  by fixed-iteration Newton (Camera.h:229-248).
- fov gating via fov_threshold = cos(fov)|cos(fov)| (Camera.cpp:144-167).
- rotations as angle-axis for calibration (Camera.cpp:114-133), and
  ray midpoints for triangulation (Camera.cpp:169-226).

One function takes torch tensors: :func:`rotation_from_angle_axis_torch`,
the Rodrigues formula of the bundle adjuster (``calib/geometric.py``),
whose forward-mode derivative stays finite at angle 0 (the reference's
goes NaN there; ROADMAP queue C).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEAR_INFINITY = 1.0e6  # Camera.cpp:14 kNearInfinity
FTHETA = 0
RECTILINEAR = 1

_TYPE_NAMES = {FTHETA: "FTHETA", RECTILINEAR: "RECTILINEAR"}
_TYPE_IDS = {v: k for k, v in _TYPE_NAMES.items()}


class Camera(NamedTuple):
    """Numeric camera parameters (host numpy)."""

    lens_type: np.ndarray  # () int32: 0=FTHETA, 1=RECTILINEAR
    position: np.ndarray  # (3,) rig-frame origin, cm
    rotation: np.ndarray  # (3,3) rows = right, up, backward
    resolution: np.ndarray  # (2,) pixels (w, h)
    principal: np.ndarray  # (2,) pixels
    focal: np.ndarray  # (2,) pixels/radian; focal[1] typically negative
    distortion: np.ndarray  # (2,) r^3, r^5 coefficients
    fov_threshold: np.ndarray  # () cos(fov)*|cos(fov)|; -1 or 0 = default

    @property
    def right(self):
        return self.rotation[..., 0, :]

    @property
    def up(self):
        return self.rotation[..., 1, :]

    @property
    def backward(self):
        return self.rotation[..., 2, :]

    @property
    def forward(self):
        return -self.rotation[..., 2, :]


def orthonormalize_rotation(forward, up, right=None):
    """(right, up, backward) rotation snapped to the nearest orthonormal
    matrix via SVD (Camera.cpp:24-28)."""
    forward = np.asarray(forward, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    if right is None:
        right = np.cross(forward, up)
    right = np.asarray(right, dtype=np.float64)
    if np.dot(np.cross(right, up), forward) >= 0:
        raise ValueError("rotation must be right-handed")
    rot = np.stack([right, up, -forward], axis=0)
    u, _, vt = np.linalg.svd(rot)
    out = u @ vt
    if np.linalg.det(out) < 0:  # keep it a proper rotation
        u[:, -1] *= -1
        out = u @ vt
    return out


def make_camera(
    lens_type,
    position,
    forward,
    up,
    resolution,
    focal,
    principal=None,
    distortion=(0.0, 0.0),
    fov=None,
    right=None,
    dtype=np.float64,
):
    """Constructor mirroring Camera::Camera(json) defaults
    (Camera.cpp:44-83)."""
    if isinstance(lens_type, str):
        lens_type = _TYPE_IDS[lens_type]
    resolution = np.asarray(resolution, dtype=dtype)
    cam = Camera(
        lens_type=np.asarray(lens_type, dtype=np.int32),
        position=np.asarray(position, dtype=dtype),
        rotation=orthonormalize_rotation(forward, up, right).astype(dtype),
        resolution=resolution,
        principal=np.asarray(
            principal if principal is not None else resolution / 2, dtype=dtype
        ),
        focal=np.asarray(focal, dtype=dtype),
        distortion=np.asarray(distortion, dtype=dtype),
        fov_threshold=np.asarray(0.0, dtype=dtype),
    )
    if fov is None:
        return set_default_fov(cam)
    return set_fov(cam, fov)


def set_fov(cam: Camera, fov) -> Camera:
    cos_fov = np.cos(fov)
    return cam._replace(
        fov_threshold=np.asarray(
            cos_fov * abs(cos_fov), dtype=np.asarray(cam.position).dtype
        )
    )


def set_default_fov(cam: Camera) -> Camera:
    # FTHETA default: sees everything (-1); RECTILINEAR: front hemisphere (0)
    thresh = -1.0 if int(cam.lens_type) == FTHETA else 0.0
    return cam._replace(
        fov_threshold=np.asarray(thresh, dtype=np.asarray(cam.position).dtype)
    )


def get_fov(cam: Camera) -> float:
    t = float(cam.fov_threshold)
    return float(np.arccos(-np.sqrt(-t)) if t < 0 else np.arccos(np.sqrt(t)))


def is_default_fov(cam: Camera) -> bool:
    t = float(cam.fov_threshold)
    return t == -1.0 if int(cam.lens_type) == FTHETA else t == 0.0


def distort_factor(cam: Camera, r_squared):
    d0 = cam.distortion[..., 0]
    d1 = cam.distortion[..., 1]
    return 1.0 + r_squared * (d0 + r_squared * d1)


def distort(cam: Camera, r):
    return distort_factor(cam, r * r) * r


def undistort(cam: Camera, d, num_steps: int = 10):
    """Invert distort() by Newton iteration with numeric derivative
    (Camera.h:229-248), fixed trip count."""
    smidgen = 1.0 / NEAR_INFINITY
    r = d
    for _ in range(num_steps):
        d0 = distort(cam, r)
        d1 = distort(cam, r + smidgen)
        derivative = (d1 - d0) / smidgen
        r = r - (d0 - d) / derivative
    return r


def _camera_to_sensor(cam: Camera, pts_cam):
    """Camera-space point (..., 3) -> distorted sensor coords (..., 2)."""
    xy = pts_cam[..., :2]
    z = pts_cam[..., 2]
    norm_xy = np.sqrt(np.sum(xy * xy, axis=-1))
    safe_norm = np.where(norm_xy == 0, 1.0, norm_xy)

    theta = np.arctan2(norm_xy, -z)
    ftheta_sensor = (distort(cam, theta) / safe_norm)[..., None] * xy

    safe_z = np.where(z == 0, -1e-20, z)
    planar = xy / (-safe_z)[..., None]
    r2 = np.sum(planar * planar, axis=-1)
    rect_sensor = distort_factor(cam, r2)[..., None] * planar

    is_ftheta = (cam.lens_type == FTHETA)[..., None]
    return np.where(is_ftheta, ftheta_sensor, rect_sensor)


def _sensor_to_camera(cam: Camera, sensor):
    """Distorted sensor coords (..., 2) -> unit camera-space direction
    (..., 3) (Camera.h:264-284)."""
    sq = np.sum(sensor * sensor, axis=-1)
    norm = np.sqrt(sq)
    safe_norm = np.where(norm == 0, 1.0, norm)
    r = undistort(cam, norm)
    angle = np.where(cam.lens_type == FTHETA, r, np.arctan(r))
    head = (np.sin(angle) / safe_norm)[..., None] * sensor
    z = -np.cos(angle)
    unit = np.concatenate([head, z[..., None]], axis=-1)
    center = np.asarray([0.0, 0.0, -1.0], dtype=unit.dtype)
    return np.where((sq == 0)[..., None], center, unit)


def _rotate(rotation, v, transpose=False):
    """Apply a (3,3) rotation to (...,3) vectors."""
    if transpose:
        rows = [np.sum(rotation[..., :, i] * v, axis=-1) for i in range(3)]
    else:
        rows = [np.sum(rotation[..., i, :] * v, axis=-1) for i in range(3)]
    return np.stack(rows, axis=-1)


def world_to_pixel(cam: Camera, pts_rig):
    """Rig-frame points (..., 3) -> pixel coords (..., 2) (Camera.h:133-140)."""
    rel = np.asarray(pts_rig) - cam.position
    pts_cam = _rotate(cam.rotation, rel)
    sensor = _camera_to_sensor(cam, pts_cam)
    return cam.focal * sensor + cam.principal


def pixel_to_camera(cam: Camera, pixel):
    """Pixel coords (..., 2) -> unit direction in camera space (..., 3)."""
    sensor = (np.asarray(pixel) - cam.principal) / cam.focal
    return _sensor_to_camera(cam, sensor)


def pixel_to_rig_direction(cam: Camera, pixel):
    """Pixel coords (..., 2) -> unit ray direction in rig space (..., 3)
    (Camera.h:143-150)."""
    unit = pixel_to_camera(cam, pixel)
    return _rotate(cam.rotation, unit, transpose=True)


def pixel_to_rig_near_infinity(cam: Camera, pixel):
    """Point kNearInfinity along the back-projected ray (Camera.h:153-155)."""
    return cam.position + NEAR_INFINITY * pixel_to_rig_direction(cam, pixel)


def is_behind(cam: Camera, pts_rig):
    """Points on or behind the camera's image plane (Camera.h:157-161)."""
    v = np.asarray(pts_rig) - cam.position
    return np.sum(cam.backward * v, axis=-1) >= 0


def is_outside_fov(cam: Camera, pts_rig):
    v = np.asarray(pts_rig) - cam.position
    dot = -np.sum(cam.backward * v, axis=-1)
    general = dot * np.abs(dot) <= cam.fov_threshold * np.sum(v * v, axis=-1)
    return np.where(cam.fov_threshold == -1.0, False, general)


def sees(cam: Camera, pts_rig):
    """Points that project inside the frame and inside the fov
    (Camera.h:174-181)."""
    p = world_to_pixel(cam, pts_rig)
    in_frame = (
        (0 <= p[..., 0])
        & (p[..., 0] < cam.resolution[..., 0])
        & (0 <= p[..., 1])
        & (p[..., 1] < cam.resolution[..., 1])
    )
    return in_frame & ~is_outside_fov(cam, pts_rig)


def approximate_usable_pixels_radius(cam: Camera) -> float:
    """Closest approach of the fov cone to the image center, in pixels
    (Camera.h:201-212)."""
    fov = get_fov(cam)
    angles = np.arange(10) * (2 * np.pi / 10.0)
    ortho = (
        np.cos(angles)[:, None] * np.asarray(cam.right)
        + np.sin(angles)[:, None] * np.asarray(cam.up)
    )
    direction = np.cos(fov) * np.asarray(cam.forward) + np.sin(fov) * ortho
    pix = world_to_pixel(cam, np.asarray(cam.position) + direction)
    d = np.linalg.norm(pix - np.asarray(cam.resolution) / 2.0, axis=-1)
    return float(min(np.linalg.norm(np.asarray(cam.resolution)), d.min()))


def overlap(cam: Camera, other: Camera, probe_count: int = 10) -> float:
    """Fraction of cam's frame visible from ``other``, probed on a
    probe_count x probe_count grid (Camera.h:184-198)."""
    ij = np.stack(
        np.meshgrid(np.arange(probe_count), np.arange(probe_count)), axis=-1
    ).reshape(-1, 2).astype(np.float64)
    pix = ij / (probe_count - 1) * np.asarray(cam.resolution)
    pts = pixel_to_rig_near_infinity(cam, pix)
    return float(np.mean(np.asarray(sees(other, pts))))


def rotation_from_angle_axis(angle_axis):
    """Rodrigues formula (Camera.cpp:114-133), (..., 3) -> (..., 3, 3)."""
    angle_axis = np.asarray(angle_axis)
    angle = np.sqrt(np.sum(angle_axis * angle_axis, axis=-1))
    safe_angle = np.where(angle < 1e-12, 1.0, angle)
    axis = angle_axis / safe_angle[..., None]
    return _rodrigues(axis, np.cos(angle), np.sin(angle), np.stack)


def _rodrigues(axis, c, s, stack):
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    C = 1.0 - c
    return stack(
        [
            stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
            stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
            stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
        ],
        -2,
    )


# below this squared angle the rotation is I + K + K^2 / 2 (K the skew
# matrix of the angle-axis): its error, ~angle^3 / 6, is below float64's
# resolution of the full formula there
_SERIES_ANGLE_SQ = 1e-10


def rotation_from_angle_axis_torch(angle_axis: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula on torch tensors, (..., 3) -> (..., 3, 3), with a
    forward-mode derivative that is finite at angle 0.

    The reference guards the value (``where(angle < 1e-12, 1, angle)``)
    but takes the square root's derivative at 0 first, so its Jacobian is
    NaN for a camera whose angle-axis is exactly 0. Here the square root
    sees a squared norm that is replaced by 1 below a small angle (a
    double ``where``), and the second-order series takes over there;
    above it the formula is the reference's."""
    sq = torch.sum(angle_axis * angle_axis, dim=-1)
    small = sq < _SERIES_ANGLE_SQ
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    full = _rodrigues(
        angle_axis / angle[..., None], torch.cos(angle), torch.sin(angle),
        torch.stack,
    )
    x, y, z = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=angle_axis.dtype, device=angle_axis.device)
    series = eye + K + 0.5 * (K @ K)
    return torch.where(small[..., None, None], series, full)


def angle_axis_from_rotation(rotation):
    """Inverse of :func:`rotation_from_angle_axis` (principal branch, angle
    in [0, pi]) by Shepperd's quaternion method, branchless, so it is
    well-conditioned at angle -> 0 and angle -> pi (the rig's 180-degree
    cameras)."""
    R = np.asarray(rotation)
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def quat(diag, i):
        # the quaternion (w, x, y, z) from the candidate whose
        # 1 + diag term is largest; component i is 0.25 * s
        s = np.sqrt(np.maximum(1.0 + diag, 1e-20)) * 2.0
        off = {
            0: [(r21 - r12), (r02 - r20), (r10 - r01)],
            1: [(r21 - r12), (r01 + r10), (r02 + r20)],
            2: [(r02 - r20), (r01 + r10), (r12 + r21)],
            3: [(r10 - r01), (r02 + r20), (r12 + r21)],
        }[i]
        comps = [o / s for o in off]
        comps.insert(i, 0.25 * s)
        return np.stack(comps, -1)

    best = np.argmax(np.stack([tr, r00, r11, r22], -1), axis=-1)[..., None]
    q = np.where(
        best == 0,
        quat(tr, 0),
        np.where(
            best == 1,
            quat(r00 - r11 - r22, 1),
            np.where(best == 2, quat(r11 - r00 - r22, 2), quat(r22 - r00 - r11, 3)),
        ),
    )
    q = q / np.sqrt(np.sum(q * q, axis=-1, keepdims=True))
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = np.sqrt(np.sum(v * v, axis=-1))
    angle = 2.0 * np.arctan2(vnorm, np.abs(w))
    sign = np.where(w < 0, -1.0, 1.0)
    safe = np.where(vnorm < 1e-20, 1.0, vnorm)
    # angle -> 0 limit: aa = 2 v (since v ~ axis * angle / 2)
    scale = np.where(vnorm < 1e-20, 2.0, angle / safe)
    return v * (sign * scale)[..., None]


def ray_midpoint(origin_a, dir_a, origin_b, dir_b, force_in_front=False):
    """Midpoint of the closest approach of two rays, (..., 3) each; parallel
    rays (or, with ``force_in_front``, a point behind either camera)
    degenerate to kNearInfinity along both rays, as the reference's
    midpoint() (Camera.cpp:169-226)."""
    origin_a, dir_a = np.asarray(origin_a), np.asarray(dir_a)
    origin_b, dir_b = np.asarray(origin_b), np.asarray(dir_b)

    def cross2(a, b):
        return -a[..., 1] * b[..., 0] + a[..., 0] * b[..., 1]

    # project onto the 2D basis spanned by the two directions
    fa = np.stack([np.sum(dir_a * dir_a, -1), np.sum(dir_b * dir_a, -1)], -1)
    fb = np.stack([np.sum(dir_a * dir_b, -1), np.sum(dir_b * dir_b, -1)], -1)
    diff = origin_a - origin_b
    fc = np.stack([np.sum(dir_a * diff, -1), np.sum(dir_b * diff, -1)], -1)
    det = cross2(fa, fb)
    safe_det = np.where(np.abs(det) < 1e-30, 1.0, det)
    ta = cross2(fb, fc) / safe_det
    tb = cross2(fa, fc) / safe_det
    degenerate = np.abs(det) < 1e-30
    if force_in_front:
        degenerate = degenerate | (ta < 0) | (tb < 0)
    ta = np.where(degenerate, NEAR_INFINITY, ta)
    tb = np.where(degenerate, NEAR_INFINITY, tb)
    pa = origin_a + ta[..., None] * dir_a
    pb = origin_b + tb[..., None] * dir_b
    return (pa + pb) / 2.0


def camera_from_json(obj: dict) -> tuple[Camera, str, str]:
    """Parse one camera dict (RIG_JSON.md). Returns (Camera, id, group)."""
    if float(obj["version"]) < 1.0:
        raise ValueError("camera version must be >= 1")
    cam = make_camera(
        lens_type=obj["type"],
        position=obj["origin"],
        forward=obj["forward"],
        up=obj["up"],
        right=obj.get("right"),
        resolution=obj["resolution"],
        focal=obj["focal"],
        principal=obj.get("principal"),
        distortion=obj.get("distortion", (0.0, 0.0)),
        fov=obj.get("fov"),
    )
    return cam, str(obj["id"]), str(obj.get("group", ""))


def camera_to_json(cam: Camera, cam_id: str, group: str = "") -> dict:
    out = {
        "version": 1,
        "type": _TYPE_NAMES[int(cam.lens_type)],
        "origin": np.asarray(cam.position, dtype=float).tolist(),
        "forward": np.asarray(cam.forward, dtype=float).tolist(),
        "up": np.asarray(cam.up, dtype=float).tolist(),
        "right": np.asarray(cam.right, dtype=float).tolist(),
        "resolution": np.asarray(cam.resolution, dtype=float).tolist(),
        "principal": np.asarray(cam.principal, dtype=float).tolist(),
        "focal": np.asarray(cam.focal, dtype=float).tolist(),
        "id": cam_id,
    }
    if np.any(np.asarray(cam.distortion) != 0):
        out["distortion"] = np.asarray(cam.distortion, dtype=float).tolist()
    if not is_default_fov(cam):
        out["fov"] = get_fov(cam)
    if group:
        out["group"] = group
    return out


def create_rescaled_camera(cam: Camera, scale: float) -> Camera:
    """Camera equivalent to resizing the sensor by ``scale``
    (Camera.cpp:273-289)."""
    res = np.asarray(cam.resolution, dtype=np.float64)
    new_res = np.floor(res * scale)
    ratio = new_res / res
    return cam._replace(
        resolution=new_res.astype(res.dtype),
        principal=np.asarray(cam.principal) * ratio,
        focal=np.asarray(cam.focal) * ratio,
    )
