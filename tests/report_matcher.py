"""The port's ORB matcher against OpenCV's on tests/test_matches.py's scene.

    python tests/report_matcher.py

On the simulator's 512 px views of the 6-camera 120 deg ring rig under the
sinusoid environment of tests/test_matches.py, prints, for each side
camera, the keypoints a pyramid level of OpenCV's ORB and of the port's,
how many of them are equal (keyed by level and float32 position) and how
many of those have bit-equal descriptors; then, for OpenCV's ORB (through
the JAX package) and for the port's, the ring pairs' right and wrong
matches (a match is right within 2 px of the true correspondence), whether
the port's matches equal OpenCV's (as sorted arrays), and the reference's
match -> calibrate loop (its perturbation, config and bounds): traces, the
median ratio and the smallest forward dot against the truth. Needs OpenCV
and the JAX package; runs on the CPU in about 15 s.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import surround360_tpu.calib.matches as JM  # noqa: E402
from chip_smoke import (  # noqa: E402
    _min_forward_dot,
    recover,
    reference_loop_rig,
    ring_pairs,
    sinusoid_environment,
)
from surround360_tpu_torch.calib import orb  # noqa: E402
from surround360_tpu_torch.calib.matches import match_keypoints  # noqa: E402
from surround360_tpu_torch.capture import render_camera_views  # noqa: E402


def level_report(grey: np.ndarray) -> str:
    """Per level: OpenCV's keypoints / the port's / equal keypoints /
    equal descriptors."""
    import cv2
    import torch

    feats = orb.detect_and_compute(torch.from_numpy(grey))
    kps, des = cv2.ORB_create(nfeatures=orb.N_FEATURES).detectAndCompute(grey, None)
    want = {(k.octave, np.float32(k.pt[0]), np.float32(k.pt[1])): d for k, d in zip(kps, des)}
    packed = np.packbits(feats.descriptors.numpy(), axis=1, bitorder="little")
    got = {(int(o), x, y): d for (x, y), o, d in zip(feats.points.numpy(),
                                                    feats.octaves.numpy(), packed)}
    cells = []
    for level in range(orb.N_LEVELS):
        w = {k for k in want if k[0] == level}
        g = {k for k in got if k[0] == level}
        same = [k for k in w & g if (want[k] == got[k]).all()]
        cells.append(f"{len(w)}/{len(g)}/{len(w & g)}/{len(same)}")
    return " ".join(cells)


def _rows(pts_a, pts_b):
    rows = np.concatenate([np.reshape(pts_a, (-1, 2)), np.reshape(pts_b, (-1, 2))], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def main():
    rig = reference_loop_rig()
    views = render_camera_views(rig, env_fn=sinusoid_environment)
    print("keypoints a level, OpenCV / port / equal / equal descriptors:")
    for i in range(1, 7):
        view = views[rig.ids.index(f"cam{i}")][:3]
        grey = orb.to_gray8(view, "cpu").numpy()
        print(f"  cam{i}: {level_report(grey)}")
    seen = {}
    for name, matcher in (("OpenCV ORB", JM.match_keypoints),
                          ("port ORB", lambda a, b: match_keypoints(a, b, device="cpu"))):
        pairs = []

        def record(a, b, matcher=matcher, pairs=pairs):
            got = matcher(a, b)
            pairs.append(_rows(*got))
            return got

        keypoints, matches, right, wrong = ring_pairs(rig, views, record)
        seen[name] = pairs
        traces, before, after, refined = recover(rig, keypoints, matches)
        print(f"{name}: {right} right, {wrong} wrong ({100 * right / (right + wrong):.0f}% "
              f"right); loop: {traces} traces, median ratio "
              f"{after['median'] / before['median']:.3f} (< 0.7), min forward dot "
              f"{_min_forward_dot(rig, refined):.5f} (> 0.999)")
    equal = all(np.array_equal(a, b) for a, b in zip(*seen.values()))
    print(f"the port's matches equal OpenCV's on all six ring pairs: {equal}")


if __name__ == "__main__":
    main()
