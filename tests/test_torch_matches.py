"""The port's match-graph tooling (surround360_tpu_torch/calib/matches.py)
and its own ORB matcher (calib/orb.py), on the CPU: the reference's cases
(tests/test_matches.py), the COLMAP converter byte-equal to the JAX
package's, BRISK and AKAZE equal to the JAX package's where OpenCV is
installed, and the simulator's match -> calibrate loop.

The port's ORB computes what OpenCV's computes, stage for stage
(tests/test_torch_orb.py holds each stage), so ``match_keypoints`` with
ORB returns the JAX package's matches: the same (x_a, y_a, x_b, y_b) rows,
compared as sorted arrays (OpenCV's keypoint order is its own). The
reference's loop then runs on the reference's own sinusoid scene and
passes its bounds, as it does on OpenCV's matches.
"""

import json
import sqlite3
import sys

import numpy as np
import pytest

import chip_smoke as cs
import surround360_tpu.calib.matches as JM
from surround360_tpu_torch.calib.matches import (
    assemble_traces,
    colmap_db_to_matches_json,
    load_matches_json,
    match_keypoints,
)
from surround360_tpu_torch.capture import render_camera_views
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# trace assembly and matches.json (the reference's cases)
# ---------------------------------------------------------------------------


def test_union_find_chains_across_pairs():
    keypoints = {"A": np.array([[10.0, 10.0]]), "B": np.array([[20.0, 10.0]]),
                 "C": np.array([[30.0, 10.0]])}
    matches = [("A", "B", np.array([[0, 0]])), ("B", "C", np.array([[0, 0]]))]
    obs = assemble_traces(keypoints, matches, {"A": 0, "B": 1, "C": 2})
    assert obs.num_points == 1
    assert len(obs.cam_idx) == 3
    assert set(obs.cam_idx.tolist()) == {0, 1, 2}


def test_ambiguous_same_camera_trace_dropped():
    keypoints = {"A": np.array([[1.0, 1.0], [5.0, 5.0]]), "B": np.array([[2.0, 2.0]])}
    obs = assemble_traces(keypoints, [("A", "B", np.array([[0, 0], [1, 0]]))],
                          {"A": 0, "B": 1})
    assert obs.num_points == 0


def test_single_view_dropped():
    keypoints = {"A": np.array([[1.0, 1.0]]), "B": np.array([[2.0, 2.0]])}
    assert assemble_traces(keypoints, [], {"A": 0, "B": 1}).num_points == 0


def test_traces_equal_jax_on_a_random_graph():
    rng = np.random.default_rng(7)
    names = ["a", "b", "c", "d"]
    keypoints = {n: rng.random((30, 2)) * 100 for n in names}
    matches = [(names[i], names[j], rng.integers(0, 30, size=(25, 2)))
               for i in range(4) for j in range(i + 1, 4)]
    cams = {n: i for i, n in enumerate(names)}
    obs, jobs = assemble_traces(keypoints, matches, cams), JM.assemble_traces(
        keypoints, matches, cams)
    assert obs.num_points == jobs.num_points > 0
    for f in ("cam_idx", "pt_idx", "pixels"):
        np.testing.assert_array_equal(getattr(obs, f), getattr(jobs, f))


def test_matches_json_roundtrip_schema(tmp_path):
    data = {
        "images": {
            "cam1.png": [{"x": "10.5", "y": "20.5", "scale": "1", "orientation": "0"}],
            "cam2.png": [{"x": "11.5", "y": "21.5", "scale": "1", "orientation": "0"}],
        },
        "all_matches": [{"image1": "cam1.png", "image2": "cam2.png",
                         "matches": [{"idx1": "0", "idx2": "0"}]}],
    }
    path = tmp_path / "matches.json"
    path.write_text(json.dumps(data))
    keypoints, matches = load_matches_json(str(path))
    assert keypoints["cam1.png"].shape == (1, 2)
    assert matches[0][0] == "cam1.png"
    np.testing.assert_array_equal(matches[0][2], [[0, 0]])


def test_colmap_db_to_matches_json_byte_equal_to_jax(tmp_path):
    """chip_smoke's COLMAP writer -> both converters: the same bytes; the
    port's 1/16 px keypoints survive float32 and the decimal strings."""
    ids = ["cam0", "cam1", "cam2"]
    keypoints = {"cam0": np.array([[10.0625, 20.5], [1999.9375, 3.125]]),
                 "cam2": np.array([[7.0, 8.25]])}
    matches = [("cam0", "cam2", np.array([[1, 0]]))]
    db = str(tmp_path / "features.db")
    cs.write_colmap_db(db, ids, keypoints, matches)
    with sqlite3.connect(db) as conn:
        assert conn.execute("SELECT pair_id FROM matches").fetchone()[0] == 1 * 2147483647 + 3
    colmap_db_to_matches_json(db, str(tmp_path / "port.json"))
    JM.colmap_db_to_matches_json(db, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    kp, m = load_matches_json(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(kp["cam0.png"], keypoints["cam0"])
    assert kp["cam1.png"].shape == (0, 2)
    np.testing.assert_array_equal(m[0][2], [[1, 0]])


# ---------------------------------------------------------------------------
# keypoint matching
# ---------------------------------------------------------------------------


def _shifted_texture():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.random((300, 400)).astype(np.float32), (0, 0), 1.5) * 255
    base = (base - base.min()) / (base.max() - base.min())
    return base[:, 20:320], base[:, 10:310]  # +10 px shift


def _sorted_rows(pts_a, pts_b) -> np.ndarray:
    """(M, 4) rows (x_a, y_a, x_b, y_b) in lexicographic order."""
    rows = np.concatenate([np.asarray(pts_a).reshape(-1, 2),
                           np.asarray(pts_b).reshape(-1, 2)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_orb_matches_shifted_texture():
    """The reference's case on the port's ORB: its bounds, and the
    positions OpenCV's ORB matches there."""
    a, b = _shifted_texture()
    pts_a, pts_b = match_keypoints(a[None], b[None], algorithm="ORB", device="cpu")
    assert len(pts_a) > 20
    dx = pts_b[:, 0] - pts_a[:, 0]
    assert abs(np.median(dx) - 10.0) < 1.0
    np.testing.assert_array_equal(_sorted_rows(pts_a, pts_b),
                                  _sorted_rows(*JM.match_keypoints(a[None], b[None])))


@pytest.mark.parametrize("algorithm", ["BRISK", "AKAZE"])
def test_opencv_algorithms_equal_jax(algorithm):
    """The same OpenCV calls as the JAX package: the same matches, or the
    same error where this OpenCV lacks the detector's factory (OpenCV 5
    has no ``cv2.BRISK_create`` / ``cv2.AKAZE_create``)."""
    a, b = _shifted_texture()
    try:
        want = JM.match_keypoints(a[None], b[None], algorithm=algorithm)
    except AttributeError as e:
        with pytest.raises(AttributeError, match=str(e)):
            match_keypoints(a[None], b[None], algorithm=algorithm)
        return
    got = match_keypoints(a[None], b[None], algorithm=algorithm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 20


def test_opencv_algorithms_without_cv2_name_orb(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
    img = np.zeros((1, 64, 64), np.float32)
    with pytest.raises(ImportError, match="ORB"):
        match_keypoints(img, img, algorithm="BRISK")


def _small_rig():
    return cs.reference_loop_rig()


@pytest.fixture(scope="module")
def scene():
    """tests/test_matches.py's scene: (rig, views) of the 6-camera ring at
    0.25 scale (512 px) under three sinusoids."""
    rig = _small_rig()
    return rig, render_camera_views(rig, env_fn=cs.sinusoid_environment)


def _port_matcher(a, b):
    return match_keypoints(a, b, device="cpu")


@pytest.mark.parametrize("i", range(1, 7))
def test_orb_against_opencv_on_the_reference_scene(scene, i):
    """Each ring pair of tests/test_matches.py's loop (cam<i>, its
    neighbour): the JAX package's matches, as sorted arrays."""
    pytest.importorskip("cv2")
    rig, views = scene
    a = views[rig.ids.index(f"cam{i}")][:3]
    b = views[rig.ids.index(f"cam{1 + i % 6}")][:3]
    got = _sorted_rows(*_port_matcher(a, b))
    np.testing.assert_array_equal(got, _sorted_rows(*JM.match_keypoints(a, b)))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, got.astype(np.float32))  # OpenCV's float32 kp.pt


def test_reference_loop_on_its_own_scene(scene):
    """tests/test_matches.py::TestEndToEndMatchCalibrate on the port: the
    sinusoid scene, ORB matches of the ring pairs, traces, the 0.004 rad
    perturbation and the locked config; its bounds (traces > 30, median <
    0.7 x the perturbed rig's, min forward dot > 0.999). On OpenCV's
    matches, which the port's equal, the loop ends at 0.99924
    (tests/report_matcher.py)."""
    rig, views = scene
    keypoints, matches, right, wrong = cs.ring_pairs(rig, views, _port_matcher)
    traces, before, after, refined = cs.recover(rig, keypoints, matches)
    assert traces > 30, traces
    assert after["median"] < 0.7 * before["median"], (before, after)
    assert cs._min_forward_dot(rig, refined) > 0.999


def test_simulator_rig_recovery_via_matcher():
    """The reference's loop (simulator images -> ORB matches -> traces ->
    BA) with the port's matcher, its rig, perturbation, config and bounds,
    on a corner-rich scene as well (chip_smoke.calibration_environment:
    grey cells of 4 deg and 1.5 deg, the 1 deg cells of phase 19 at 512
    px): every pair's matches are OpenCV's, and the loop passes."""
    pytest.importorskip("cv2")
    rig = _small_rig()
    views = render_camera_views(rig, env_fn=lambda d: cs.calibration_environment(d, 4.0))
    pairs = []

    def both(a, b):
        got = _port_matcher(a, b)
        pairs.append((_sorted_rows(*got), _sorted_rows(*JM.match_keypoints(a, b))))
        return got

    keypoints, matches, right, wrong = cs.ring_pairs(rig, views, both)
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
    assert (right, wrong) == (207, 136)  # OpenCV's ORB on this scene
    traces, before, after, refined = cs.recover(rig, keypoints, matches)
    assert traces > 30, traces
    assert after["median"] < 0.7 * before["median"], (before, after)
    assert cs._min_forward_dot(rig, refined) > 0.999
