"""Match-graph tooling: keypoint matching, matches.json io, trace assembly.

Port of ``surround360_tpu/calib/matches.py``, which covers three reference
components:
- keypoint matching (calibration/KeypointMatchers.{h,cpp}): ORB, the
  default and the only algorithm a caller of either package uses, runs on
  the port's own detector and matcher (``calib/orb.py``) on the device;
  BRISK and AKAZE go through OpenCV on the host as in the reference, and
  need ``cv2``, imported only when they are asked for;
- the COLMAP features-db -> matches.json converter
  (scripts/geometric_calibration.py:68-117), same JSON schema;
- trace assembly (assembleTraces, GeometricCalibration.cpp:435-476):
  union-find over (image, keypoint) nodes connected by matches, producing
  CalibrationObservations for the bundle adjuster. Traces observing the
  same camera twice are dropped as ambiguous.
"""

from __future__ import annotations

import json
import sqlite3

import numpy as np

from .geometric import CalibrationObservations
from .orb import orb_match

__all__ = [
    "match_keypoints",
    "colmap_db_to_matches_json",
    "load_matches_json",
    "assemble_traces",
]


def match_keypoints(
    image_a: np.ndarray,  # (3|1, H, W) float [0,1]
    image_b: np.ndarray,
    algorithm: str = "ORB",
    max_distance_ratio: float = 0.75,
    device="cuda",
):
    """Detect + match keypoints between two images
    (getKeypointMatchesWithBRISK/ORB/AKAZE, KeypointMatchers.cpp:47-110).
    Returns (pts_a (M, 2), pts_b (M, 2)). ``device`` is where ORB runs;
    BRISK and AKAZE run on the host."""
    if algorithm not in ("BRISK", "AKAZE"):
        return orb_match(image_a, image_b, max_distance_ratio, device)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"match_keypoints: {algorithm} needs OpenCV (cv2), which is not "
            "installed; algorithm='ORB' is the port's own matcher and needs "
            "no OpenCV"
        ) from e

    def to8(img):
        arr = np.asarray(img)
        if arr.ndim == 3:
            arr = np.moveaxis(arr, 0, -1)
            if arr.shape[-1] >= 3:
                arr = cv2.cvtColor(
                    arr[..., :3].astype(np.float32), cv2.COLOR_RGB2GRAY
                )
            else:
                arr = arr[..., 0]
        return (np.clip(arr, 0, 1) * 255).astype(np.uint8)

    det = cv2.BRISK_create() if algorithm == "BRISK" else cv2.AKAZE_create()
    kp_a, desc_a = det.detectAndCompute(to8(image_a), None)
    kp_b, desc_b = det.detectAndCompute(to8(image_b), None)
    if desc_a is None or desc_b is None or len(kp_a) < 2 or len(kp_b) < 2:
        return np.zeros((0, 2)), np.zeros((0, 2))
    knn = cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch(desc_a, desc_b, k=2)
    pts_a, pts_b = [], []
    for pair in knn:
        if len(pair) == 2 and pair[0].distance < max_distance_ratio * pair[1].distance:
            pts_a.append(kp_a[pair[0].queryIdx].pt)
            pts_b.append(kp_b[pair[0].trainIdx].pt)
    return np.asarray(pts_a), np.asarray(pts_b)


def colmap_db_to_matches_json(db_path: str, json_path: str) -> None:
    """COLMAP sqlite database -> matches.json
    (features_db_to_json, scripts/geometric_calibration.py:68-117)."""
    data = {"images": {}, "all_matches": []}
    images = {}
    conn = sqlite3.connect(db_path)
    try:
        cur = conn.cursor()
        for image_id, _cam, name in cur.execute(
            "SELECT image_id, camera_id, name FROM images;"
        ):
            images[image_id] = name
            data["images"][name] = []
            kp_cur = conn.cursor()
            for (blob,) in kp_cur.execute(
                "SELECT data FROM keypoints WHERE image_id=?;", (image_id,)
            ):
                kps = np.frombuffer(blob, dtype=np.uint32).reshape(-1, 4)
                for kp in kps:
                    x, y, scale, orientation = kp.view(np.float32)
                    data["images"][name].append(
                        {
                            "x": str(x),
                            "y": str(y),
                            "scale": str(scale),
                            "orientation": str(orientation),
                        }
                    )
            kp_cur.close()
        for pair_id, blob in cur.execute(
            "SELECT pair_id, data FROM matches WHERE data IS NOT NULL;"
        ):
            inliers = np.frombuffer(blob, dtype=np.uint32).reshape(-1, 2)
            image_id2 = pair_id % 2147483647
            image_id1 = (pair_id - image_id2) // 2147483647
            data["all_matches"].append(
                {
                    "image1": images[image_id1],
                    "image2": images[image_id2],
                    "matches": [
                        {"idx1": str(i1), "idx2": str(i2)} for i1, i2 in inliers
                    ],
                }
            )
        cur.close()
    finally:
        conn.close()
    with open(json_path, "w") as f:
        json.dump(data, f, sort_keys=True, indent=4)


def load_matches_json(path: str):
    """matches.json -> (keypoints: {image_name: (K, 2) array},
    matches: [(image1, image2, (M, 2) index pairs)])."""
    with open(path) as f:
        data = json.load(f)
    keypoints = {
        name: np.asarray(
            [[float(kp["x"]), float(kp["y"])] for kp in kps]
        ).reshape(-1, 2)
        for name, kps in data["images"].items()
    }
    matches = [
        (
            m["image1"],
            m["image2"],
            np.asarray(
                [[int(mm["idx1"]), int(mm["idx2"])] for mm in m["matches"]]
            ).reshape(-1, 2),
        )
        for m in data["all_matches"]
    ]
    return keypoints, matches


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        root = x
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def assemble_traces(
    keypoints: dict,
    matches: list,
    image_to_camera: dict,  # image name -> camera index in the rig
) -> CalibrationObservations:
    """Union-find trace assembly (assembleTraces,
    GeometricCalibration.cpp:435-476). Traces that observe one camera more
    than once are dropped; surviving traces become world points observed by
    their member keypoints."""
    uf = _UnionFind()
    for img1, img2, idx_pairs in matches:
        for i1, i2 in idx_pairs:
            uf.union((img1, int(i1)), (img2, int(i2)))

    groups: dict = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)

    cam_idx, pt_idx, pixels = [], [], []
    next_pt = 0
    for members in groups.values():
        cams = [image_to_camera[img] for img, _ in members]
        if len(members) < 2 or len(set(cams)) != len(cams):
            continue  # single view or ambiguous same-camera trace
        for (img, kp_i), cam in zip(members, cams):
            cam_idx.append(cam)
            pt_idx.append(next_pt)
            pixels.append(keypoints[img][kp_i])
        next_pt += 1
    return CalibrationObservations(
        np.asarray(cam_idx, np.int32),
        np.asarray(pt_idx, np.int32),
        np.asarray(pixels, np.float64).reshape(-1, 2),
        next_pt,
    )
