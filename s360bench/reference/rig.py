"""Rig description: load/save rig JSON, side/top/bottom camera selection.

Port of ``surround360_tpu/geometry/rig.py`` (reference:
surround360_render/source/render/RigDescription.{h,cpp}) plus the same
parametric ring-rig generator, so tests and the capture simulator need no
checked-in data. ``stack_cameras`` turns a list of cameras into one
Camera whose fields carry a leading camera axis.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .camera import (
    FTHETA,
    RECTILINEAR,
    Camera,
    camera_from_json,
    camera_to_json,
    create_rescaled_camera,
    make_camera,
)


def stack_cameras(cams: list[Camera], dtype=None) -> Camera:
    """Stack N cameras into one Camera with a leading dim N per field."""
    return Camera(*(
        np.stack([np.asarray(getattr(c, f), dtype=dtype) for c in cams])
        for f in Camera._fields
    ))


@dataclass
class Rig:
    """Cameras plus ids/groups, with the selection rules of
    RigDescription (RigDescription.cpp:18-78)."""

    cameras: list[Camera]
    ids: list[str]
    groups: list[str]
    filename: str = ""
    _side_idx: list[int] = field(default_factory=list)

    def __post_init__(self):
        self._side_idx = [i for i, g in enumerate(self.groups) if "side" in g]
        if not self._side_idx:
            raise ValueError("rig has no side cameras")

    @property
    def side_cameras(self) -> list[Camera]:
        return [self.cameras[i] for i in self._side_idx]

    @property
    def side_ids(self) -> list[str]:
        return [self.ids[i] for i in self._side_idx]

    @property
    def side_camera_count(self) -> int:
        return len(self._side_idx)

    @staticmethod
    def _dist_cam_axis_to_rig_center(cam: Camera) -> float:
        pos = np.asarray(cam.position, dtype=np.float64)
        fwd = np.asarray(cam.forward, dtype=np.float64)
        return float(np.linalg.norm(np.cross(pos, fwd)))

    def find_camera_by_direction(
        self, direction, dist_cam_axis_to_rig_center_max: float = 1.0
    ) -> int:
        direction = np.asarray(direction, dtype=np.float64)
        best = None
        best_dot = -np.inf
        for i, cam in enumerate(self.cameras):
            if (
                self._dist_cam_axis_to_rig_center(cam)
                > dist_cam_axis_to_rig_center_max
            ):
                continue
            dot = float(np.dot(np.asarray(cam.forward), direction))
            if best is None or dot > best_dot:
                best, best_dot = i, dot
        if best is None:
            raise ValueError("no camera matches direction constraint")
        return best

    @property
    def top_camera_index(self) -> int:
        return self.find_camera_by_direction([0.0, 0.0, 1.0])

    @property
    def bottom_camera_index(self) -> int:
        return self.find_camera_by_direction([0.0, 0.0, -1.0])

    @property
    def bottom_camera2_index(self) -> int:
        # secondary bottom camera = largest distance cam axis to rig center
        dists = [self._dist_cam_axis_to_rig_center(c) for c in self.cameras]
        return int(np.argmax(dists))

    @property
    def ring_radius(self) -> float:
        return float(np.linalg.norm(np.asarray(self.side_cameras[0].position)))

    def camera_by_id(self, cam_id: str) -> Camera:
        return self.cameras[self.ids.index(cam_id)]

    def stacked_side_cameras(self) -> Camera:
        return stack_cameras(self.side_cameras)

    def rescaled(self, scale: float) -> "Rig":
        """Every camera rescaled (createRescaledCamera, Camera.cpp:273-289)."""
        return Rig(
            cameras=[create_rescaled_camera(c, scale) for c in self.cameras],
            ids=list(self.ids),
            groups=list(self.groups),
            filename=self.filename,
        )


def load_rig(filename: str) -> Rig:
    with open(filename) as f:
        obj = json.load(f)
    cams, ids, groups = [], [], []
    for c in obj["cameras"]:
        cam, cam_id, group = camera_from_json(c)
        cams.append(cam)
        ids.append(cam_id)
        groups.append(group)
    return Rig(cameras=cams, ids=ids, groups=groups, filename=filename)


def save_rig(filename: str, rig: Rig) -> None:
    out = {
        "cameras": [
            camera_to_json(c, i, g)
            for c, i, g in zip(rig.cameras, rig.ids, rig.groups)
        ]
    }
    with open(filename, "w") as f:
        json.dump(out, f, indent=2)


def make_ring_rig(
    num_side_cameras: int = 14,
    ring_radius_cm: float = 21.8,
    side_resolution=(2048, 2048),
    side_fov_degrees: float = 77.8,
    fisheye_resolution=(2048, 2048),
    fisheye_fov_degrees: float = 185.0,
    vertical_offset_cm: float = 13.1,
    bottom2_offset_cm: float = 9.8,
    distortion=(0.0, 0.0),
) -> Rig:
    """A Surround360-style rig: ``num_side_cameras`` RECTILINEAR cameras
    on a horizontal ring facing outward, one upward FTHETA top camera, one
    downward FTHETA primary bottom camera and one offset secondary bottom
    camera (the same geometry as the reference package's generator)."""
    cams, ids, groups = [], [], []

    half_fov = np.deg2rad(fisheye_fov_degrees) / 2.0
    f_fisheye = fisheye_resolution[0] / np.deg2rad(fisheye_fov_degrees)
    cams.append(
        make_camera(
            FTHETA,
            position=[0.0, 0.0, vertical_offset_cm],
            forward=[0.0, 0.0, 1.0],
            up=[0.0, 1.0, 0.0],
            resolution=fisheye_resolution,
            focal=[f_fisheye, -f_fisheye],
            fov=half_fov,
        )
    )
    ids.append("cam0")
    groups.append("")

    f_side = (side_resolution[0] / 2.0) / np.tan(
        np.deg2rad(side_fov_degrees) / 2.0
    )
    for i in range(num_side_cameras):
        angle = -2.0 * np.pi * i / num_side_cameras  # clockwise like reference
        fwd = np.array([np.cos(angle), np.sin(angle), 0.0])
        cams.append(
            make_camera(
                RECTILINEAR,
                position=ring_radius_cm * fwd,
                forward=fwd,
                up=[0.0, 0.0, 1.0],
                resolution=side_resolution,
                focal=[f_side, -f_side],
                distortion=distortion,
            )
        )
        ids.append(f"cam{i + 1}")
        groups.append("side camera")

    cams.append(
        make_camera(
            FTHETA,
            position=[0.0, 0.0, -vertical_offset_cm],
            forward=[0.0, 0.0, -1.0],
            up=[0.0, 1.0, 0.0],
            resolution=fisheye_resolution,
            focal=[f_fisheye, -f_fisheye],
            fov=half_fov,
        )
    )
    ids.append(f"cam{num_side_cameras + 1}")
    groups.append("")

    cams.append(
        make_camera(
            FTHETA,
            position=[0.0, bottom2_offset_cm, -vertical_offset_cm],
            forward=[0.0, 0.0, -1.0],
            up=[0.0, -1.0, 0.0],
            resolution=fisheye_resolution,
            focal=[f_fisheye, -f_fisheye],
            fov=half_fov,
        )
    )
    ids.append(f"cam{num_side_cameras + 2}")
    groups.append("")

    return Rig(cameras=cams, ids=ids, groups=groups)
