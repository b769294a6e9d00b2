"""The benchmark's scene, rendered through the rig's lenses on the device.

A torch copy of the capture simulator's scene and lens model
(``surround360_tpu_torch/capture/simulator.py::render_camera_views`` and
``geometry/camera.py::pixel_to_rig_direction``): each camera's rays, in
float64, hit a sphere of radius ``distance`` cm around the rig, and the
colour is the simulator's sinusoid environment of the hit direction, with
phases and a rotation of the scene as parameters. With zero phases and
no rotation it is the simulator's scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FTHETA = 0  # the camera model's lens types
NEAR_INFINITY = 1.0e6


def environment(direction: torch.Tensor, phases, sharpness: float = 6.0) -> torch.Tensor:
    """RGB (..., 3) of unit directions (..., 3): the simulator's
    ``checker_sinusoid_environment`` with a phase added to each of its six
    sinusoids."""
    x, y, z = direction.unbind(-1)
    p = [float(v) for v in phases]
    s = sharpness
    r = 0.5 + 0.25 * torch.sin(s * x + p[0]) + 0.25 * torch.cos(s * y * 0.7 + p[1])
    g = 0.5 + 0.25 * torch.sin(s * 0.8 * y + 1.0 + p[2]) + 0.25 * torch.sin(s * 0.5 * z + p[3])
    b = 0.5 + 0.25 * torch.cos(s * 0.6 * x + 2.0 + p[4]) + 0.25 * torch.sin(s * 0.9 * z + 1.0 + p[5])
    return torch.stack([r, g, b], dim=-1)


def _undistort(distortion, d, num_steps: int = 10):
    """Newton inversion of r (1 + d0 r^2 + d1 r^4) = d, as the camera model
    does it (fixed trip count, numeric derivative)."""
    d0, d1 = float(distortion[0]), float(distortion[1])
    dist = lambda r: (1.0 + r * r * (d0 + r * r * d1)) * r
    smidgen = 1.0 / NEAR_INFINITY
    r = d
    for _ in range(num_steps):
        v0 = dist(r)
        derivative = (dist(r + smidgen) - v0) / smidgen
        r = r - (v0 - d) / derivative
    return r


def camera_rays(cam, device) -> torch.Tensor:
    """Unit rig-frame ray of every pixel of ``cam`` (a camera-model
    NamedTuple of numpy fields), (H, W, 3) float64 on ``device``."""
    W, H = (int(v) for v in np.asarray(cam.resolution))
    f64 = dict(dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    principal = torch.as_tensor(np.asarray(cam.principal, np.float64), **f64)
    focal = torch.as_tensor(np.asarray(cam.focal, np.float64), **f64)
    sensor = (torch.stack([gx, gy], dim=-1) - principal) / focal
    norm = torch.sqrt((sensor * sensor).sum(-1))
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    r = _undistort(np.asarray(cam.distortion), norm)
    angle = r if int(cam.lens_type) == FTHETA else torch.atan(r)
    head = (torch.sin(angle) / safe)[..., None] * sensor
    unit = torch.cat([head, -torch.cos(angle)[..., None]], dim=-1)
    center = torch.tensor([0.0, 0.0, -1.0], **f64)
    unit = torch.where((norm == 0)[..., None], center, unit)
    rot = torch.as_tensor(np.asarray(cam.rotation, np.float64), **f64)
    return unit @ rot  # rows of rot are the camera's axes: R^T applied


def rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Scene rotation (3, 3): about z by yaw, then y by pitch, then x by
    roll (radians)."""
    cz, sz, cy, sy, cx, sx = (f(a) for a in (yaw, pitch, roll) for f in (math.cos, math.sin))
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rx @ ry @ rz


def render_view(cam, rays: torch.Tensor, distance: float, phases, rot: np.ndarray,
                sharpness: float = 6.0) -> torch.Tensor:
    """(3, H, W) float32 RGB of ``cam`` (rays from :func:`camera_rays`):
    the first hit of each ray on the sphere of radius ``distance`` around
    the rig centre, its direction turned by ``rot``, coloured by
    :func:`environment`."""
    origin = torch.as_tensor(np.asarray(cam.position, np.float64), device=rays.device)
    b = (rays * origin).sum(-1)
    c = float((origin * origin).sum()) - distance ** 2
    t_hit = -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))
    hit = origin + t_hit[..., None] * rays
    hit_dir = hit / torch.linalg.vector_norm(hit, dim=-1, keepdim=True)
    hit_dir = hit_dir @ torch.as_tensor(rot, device=rays.device).T
    return environment(hit_dir, phases, sharpness).float().permute(2, 0, 1)
