"""The port's ORB matcher against OpenCV's on tests/test_matches.py's scene.

    python tests/report_matcher.py

On the simulator's 512 px views of the 6-camera 120 deg ring rig under the
sinusoid environment of tests/test_matches.py, each ring neighbour pair
is matched by OpenCV's ORB (through the JAX package), by the port's ORB
with its learned BRIEF pattern, and by the port's ORB with a random
Gaussian pattern (BRIEF's sigma = 31 / 5, clipped to 13 px, seed 31).
Prints, for each, the right and wrong matches (a match is right within 2
px of the true correspondence) and the reference's match -> calibrate loop
(its perturbation, config and bounds): the median ratio and the smallest
forward dot against the truth. Needs OpenCV and the JAX package; runs on
the CPU in about 20 s.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import surround360_tpu.calib.matches as JM  # noqa: E402
import surround360_tpu_torch.calib.orb as orb  # noqa: E402
from surround360_tpu_torch.calib.geometric import (  # noqa: E402
    GeometricCalibrationConfig,
    calibrate_geometric,
    perturb_rig,
    reprojection_errors,
    reprojection_report,
    triangulate_points,
)
from surround360_tpu_torch.calib.matches import assemble_traces, match_keypoints  # noqa: E402
from surround360_tpu_torch.capture import (  # noqa: E402
    checker_sinusoid_environment,
    render_camera_views,
)
from surround360_tpu_torch.geometry import camera as C  # noqa: E402
from surround360_tpu_torch.geometry.rig import make_ring_rig  # noqa: E402


def sinusoids(d):
    return (0.5 * checker_sinusoid_environment(d, sharpness=23.7)
            + 0.3 * checker_sinusoid_environment(d, sharpness=57.1)
            + 0.2 * checker_sinusoid_environment(d, sharpness=118.9))


def ring_pairs(rig, views, matcher):
    """Side cameras cam1..cam6 matched with their ring neighbour, as the
    reference's loop does (pairs with fewer than 8 matches left out):
    (keypoints, matches, right, wrong), a match being right within 2 px of
    the true correspondence."""
    keypoints, matches, right, wrong = {}, [], 0, 0
    for i in range(1, 7):
        j = 1 + (i % 6)
        id_a, id_b = f"cam{i}", f"cam{j}"
        ia, ib = rig.ids.index(id_a), rig.ids.index(id_b)
        pa, pb = matcher(views[ia][:3], views[ib][:3])
        if len(pa):
            far = C.pixel_to_rig_near_infinity(rig.cameras[ia], pa)
            err = np.linalg.norm(C.world_to_pixel(rig.cameras[ib], far) - pb, axis=1)
            right += int((err < 2).sum())
            wrong += int((err >= 2).sum())
        if len(pa) < 8:
            continue
        base_a = len(keypoints.setdefault(id_a, np.zeros((0, 2))))
        base_b = len(keypoints.setdefault(id_b, np.zeros((0, 2))))
        keypoints[id_a] = np.concatenate([keypoints[id_a], pa])
        keypoints[id_b] = np.concatenate([keypoints[id_b], pb])
        matches.append((id_a, id_b, np.stack(
            [base_a + np.arange(len(pa)), base_b + np.arange(len(pb))], axis=1)))
    return keypoints, matches, right, wrong


def recover(rig, keypoints, matches):
    """The reference's match -> calibrate loop on the traces: (traces,
    report before, report after, refined rig)."""
    obs = assemble_traces(keypoints, matches, {f"cam{i}": rig.ids.index(f"cam{i}")
                                               for i in range(1, 7)})
    bad = perturb_rig(rig, rotation_amount=0.004, principal_amount=0.0)
    before = reprojection_report(
        reprojection_errors(bad, obs, triangulate_points(bad, obs, "cpu"), "cpu"))
    cfg = GeometricCalibrationConfig(passes=4, lm_iterations=10, outlier_factor=3.0,
                                     lock_focal=True, lock_distortion=True,
                                     lock_principal=True)
    refined, after = calibrate_geometric(bad, obs, cfg, device="cpu")
    return obs.num_points, before, after, refined


def min_forward_dot(truth, rig):
    return min(float(np.dot(t.forward, r.forward)) for t, r in zip(truth.cameras, rig.cameras))


def main():
    rig = make_ring_rig(num_side_cameras=6, side_fov_degrees=120.0).rescaled(0.25)
    views = render_camera_views(rig, env_fn=sinusoids)
    learned = orb._PATTERN
    random = np.clip(np.rint(np.random.default_rng(31).normal(
        scale=31 / 5.0, size=(256, 4))), -13, 13).astype(np.int64)
    rows = [("OpenCV ORB", JM.match_keypoints, None),
            ("port ORB, learned pattern", None, learned),
            ("port ORB, random pattern", None, random)]
    for name, matcher, pattern in rows:
        if pattern is not None:
            orb._PATTERN = pattern
            matcher = lambda a, b: match_keypoints(a, b, device="cpu")  # noqa: E731
        keypoints, matches, right, wrong = ring_pairs(rig, views, matcher)
        traces, before, after, refined = recover(rig, keypoints, matches)
        print(f"{name}: {right} right, {wrong} wrong ({100 * right / (right + wrong):.0f}% "
              f"right); loop: {traces} traces, median ratio "
              f"{after['median'] / before['median']:.3f} (< 0.7), min forward dot "
              f"{min_forward_dot(rig, refined):.5f} (> 0.999)")
    orb._PATTERN = learned


if __name__ == "__main__":
    main()
