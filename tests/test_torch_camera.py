"""The reference's camera-model cases (tests/test_camera.py) run on the
port's ``geometry/camera.py`` and ``geometry/rig.py``: every case whose
functions the port has. Where a case computes numbers, the port's are
also held to the JAX package's on the same inputs (host float64 in both:
equal up to the last bits).

Left out: ``to_device`` and the ``jax.vmap`` over stacked cameras (JAX
only); ``stack_cameras`` is held by a loop over the stacked fields instead.
"""

import numpy as np
import pytest

import surround360_tpu.geometry.camera as JC
import surround360_tpu_torch.geometry.camera as TC
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig
from surround360_tpu_torch.geometry import (
    FTHETA,
    RECTILINEAR,
    Camera,
    camera_from_json,
    camera_to_json,
    create_rescaled_camera,
    make_camera,
    pixel_to_rig_direction,
    pixel_to_rig_near_infinity,
    sees,
    world_to_pixel,
)
from surround360_tpu_torch.geometry.rig import (
    load_rig,
    make_ring_rig,
    save_rig,
    stack_cameras,
)


def _random_ftheta(mod, seed=0, distortion=(0.0, 0.0)):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return mod.make_camera(
        FTHETA, position=rng.normal(size=3) * 10, forward=q[:, 0], up=q[:, 1],
        resolution=[2448, 2048], focal=[1240.0, -1240.0], distortion=distortion,
    )


def test_center_pixel_is_principal():
    cam = _random_ftheta(TC, 1)
    center = world_to_pixel(cam, np.asarray(cam.position) + np.asarray(cam.forward))
    np.testing.assert_allclose(center, [2448 / 2, 2048 / 2], atol=1e-9)


@pytest.mark.parametrize("distortion", [(0.0, 0.0), (0.2, 0.02)])
@pytest.mark.parametrize("lens", [FTHETA, RECTILINEAR])
def test_rig_undoes_pixel(lens, distortion):
    rng = np.random.default_rng(2)
    if lens == RECTILINEAR:
        cam = make_camera(lens, position=[1.0, -2.0, 0.5], forward=[1, 0, 0], up=[0, 0, 1],
                          resolution=[2048, 2048], focal=[1269.58, -1269.58],
                          distortion=distortion)
    else:
        cam = _random_ftheta(TC, 3, distortion)
    d = 3.1
    for _ in range(20):
        v = rng.normal(size=3)
        v[1:] *= 0.5
        v[0] = abs(v[0]) + 1.0
        direction = v / np.linalg.norm(v)
        if lens == FTHETA:
            direction = np.asarray(cam.forward) * 0.5 + 0.8 * direction
            direction /= np.linalg.norm(direction)
        expected = np.asarray(cam.position) + d * direction
        pix = world_to_pixel(cam, expected)
        actual = np.asarray(cam.position) + d * pixel_to_rig_direction(cam, pix)
        np.testing.assert_allclose(actual, expected, atol=1e-6)


def test_distort_undistort_roundtrip():
    cam = _random_ftheta(TC, 4, distortion=(0.2, 0.02))
    d = TC.distort(cam, 3.0)
    assert abs(TC.undistort(cam, d) - 3.0) < 1e-6
    assert d == JC.distort(_random_ftheta(JC, 4, distortion=(0.2, 0.02)), 3.0)


def test_vectorized_matches_scalar_and_jax():
    cam = _random_ftheta(TC, 5, distortion=(0.05, 0.001))
    pts = np.random.default_rng(6).normal(size=(7, 11, 3)) * 100
    batch = world_to_pixel(cam, pts)
    for i in range(7):
        for j in range(0, 11, 3):
            np.testing.assert_allclose(batch[i, j], world_to_pixel(cam, pts[i, j]), rtol=1e-12)
    jcam = _random_ftheta(JC, 5, distortion=(0.05, 0.001))
    np.testing.assert_allclose(batch, JC.world_to_pixel(jcam, pts), rtol=1e-12)


def test_fov_roundtrip():
    cam = _random_ftheta(TC, 7)
    for fov in [0.9 * np.pi, 0.1 * np.pi, np.pi / 3]:
        assert abs(TC.get_fov(TC.set_fov(cam, fov)) - fov) < 1e-10


def test_fov_gates_visibility():
    cam = _random_ftheta(TC, 8)
    assert TC.is_default_fov(cam)
    corner_pt = pixel_to_rig_near_infinity(cam, np.array([1.0, 1.0]))
    center_pt = pixel_to_rig_near_infinity(cam, np.array([1200.0, 1000.0]))
    assert bool(sees(cam, corner_pt))
    cam_narrow = TC.set_fov(cam, 0.1 * np.pi)
    assert not bool(sees(cam_narrow, corner_pt))
    assert bool(sees(cam_narrow, center_pt))
    assert bool(sees(TC.set_default_fov(cam_narrow), corner_pt))
    jnarrow = JC.set_fov(_random_ftheta(JC, 8), 0.1 * np.pi)
    pts = np.stack([corner_pt, center_pt])
    np.testing.assert_array_equal(sees(cam_narrow, pts), np.asarray(JC.sees(jnarrow, pts)))


def test_rectilinear_default_sees_front_hemisphere_only():
    cam = make_camera(RECTILINEAR, position=[0, 0, 0], forward=[1, 0, 0], up=[0, 0, 1],
                      resolution=[2048, 2048], focal=[1269.58, -1269.58])
    assert bool(TC.is_behind(cam, np.array([-5.0, 0.0, 0.0])))
    assert not bool(sees(cam, np.array([-5.0, 0.0, 0.0])))
    assert bool(sees(cam, np.array([5.0, 0.0, 0.0])))


def test_json_roundtrip():
    cam = TC.set_fov(_random_ftheta(TC, 9, distortion=(0.1, -0.01)), 1.61443)
    obj = camera_to_json(cam, "cam9", "side camera")
    cam2, cam_id, group = camera_from_json(obj)
    assert cam_id == "cam9" and group == "side camera"
    for f in Camera._fields:
        np.testing.assert_allclose(np.asarray(getattr(cam, f)),
                                   np.asarray(getattr(cam2, f)), atol=1e-12)
    assert obj == JC.camera_to_json(JC.set_fov(_random_ftheta(
        JC, 9, distortion=(0.1, -0.01)), 1.61443), "cam9", "side camera")


def test_rig_roundtrip(tmp_path):
    rig = make_ring_rig()
    path = str(tmp_path / "rig.json")
    save_rig(path, rig)
    rig2 = load_rig(path)
    assert rig2.ids == rig.ids
    assert rig2.side_camera_count == 14
    for c1, c2 in zip(rig.cameras, rig2.cameras):
        np.testing.assert_allclose(c1.rotation, c2.rotation, atol=1e-12)
        np.testing.assert_allclose(c1.fov_threshold, c2.fov_threshold, atol=1e-12)


def test_defaults_match_reference_semantics():
    obj = {"version": 1, "type": "FTHETA", "origin": [0, 0, 13.1], "forward": [0, 0, 1],
           "up": [0, 1, 0], "right": [-1, 0, 0], "resolution": [2048, 2048],
           "focal": [483.76, -483.76], "id": "cam0"}
    cam, _, _ = camera_from_json(obj)
    np.testing.assert_allclose(cam.principal, [1024, 1024])
    np.testing.assert_allclose(cam.distortion, [0, 0])
    assert float(cam.fov_threshold) == -1.0


def test_ring_rig_selection():
    rig = make_ring_rig()
    assert len(rig.cameras) == 17
    assert rig.side_camera_count == 14
    assert rig.ids[rig.top_camera_index] == "cam0"
    assert rig.ids[rig.bottom_camera_index] == "cam15"
    assert rig.ids[rig.bottom_camera2_index] == "cam16"
    assert abs(rig.ring_radius - 21.8) < 1e-9
    jr = jax_rig()
    assert (rig.top_camera_index, rig.bottom_camera_index, rig.bottom_camera2_index) == (
        jr.top_camera_index, jr.bottom_camera_index, jr.bottom_camera2_index)


def test_rescaled_projection_scales():
    cam = _random_ftheta(TC, 12)
    half = create_rescaled_camera(cam, 0.5)
    pt = np.asarray(cam.position) + np.asarray(cam.forward) * 2 + np.array([0.1, 0.2, -0.1])
    np.testing.assert_allclose(world_to_pixel(half, pt), world_to_pixel(cam, pt) * 0.5,
                               rtol=1e-9)


def test_adjacent_side_cameras_overlap():
    rig = make_ring_rig()
    sides = rig.side_cameras
    ov = TC.overlap(sides[0], sides[1])
    assert ov > 0.2, f"adjacent side cameras should overlap, got {ov}"
    assert TC.overlap(sides[0], sides[7]) == 0.0
    jsides = jax_rig().side_cameras
    assert ov == JC.overlap(jsides[0], jsides[1])


def test_stacked_cameras_project_as_each():
    rig = make_ring_rig()
    stacked = stack_cameras(rig.side_cameras)
    assert stacked.rotation.shape == (14, 3, 3)
    pts = np.array([100.0, 30.0, 5.0])
    for i, cam in enumerate(rig.side_cameras):
        one = Camera(*(f[i] for f in stacked))
        np.testing.assert_array_equal(world_to_pixel(one, pts), world_to_pixel(cam, pts))
    assert rig.camera_by_id("cam3") is rig.cameras[3]
    side = rig.stacked_side_cameras()
    for f in Camera._fields:
        np.testing.assert_array_equal(getattr(side, f), getattr(stacked, f))


def test_angle_axis_roundtrip():
    rng = np.random.default_rng(10)
    for _ in range(10):
        aa = rng.normal(size=3)
        rot = TC.rotation_from_angle_axis(aa)
        aa2 = TC.angle_axis_from_rotation(rot)
        np.testing.assert_allclose(rot, TC.rotation_from_angle_axis(aa2), atol=1e-10)
        # host float64 in both packages: the same bits
        np.testing.assert_array_equal(rot, JC.rotation_from_angle_axis(aa, xp=np))
        np.testing.assert_array_equal(aa2, JC.angle_axis_from_rotation(rot, xp=np))


def test_angle_axis_at_zero_and_pi():
    """The ring rig's cameras include angle 0 (cam15) and pi (cam0, cam16):
    both packages return the same angle-axis there, and it round-trips."""
    for cam in make_ring_rig().cameras:
        aa = TC.angle_axis_from_rotation(cam.rotation)
        np.testing.assert_array_equal(aa, JC.angle_axis_from_rotation(cam.rotation, xp=np))
        np.testing.assert_allclose(TC.rotation_from_angle_axis(aa), cam.rotation, atol=1e-12)


def test_torch_rodrigues_matches_and_is_differentiable_at_zero():
    """The solver's torch Rodrigues equals the host one away from 0, and its
    forward-mode Jacobian at 0 is finite: the skew generators."""
    import torch

    rng = np.random.default_rng(13)
    aa = np.concatenate([rng.normal(size=(20, 3)), rng.normal(size=(5, 3)) * 1e-7,
                         np.zeros((1, 3))])
    got = TC.rotation_from_angle_axis_torch(torch.as_tensor(aa)).numpy()
    np.testing.assert_allclose(got, TC.rotation_from_angle_axis(aa), rtol=0, atol=1e-15)
    J = torch.func.jacfwd(TC.rotation_from_angle_axis_torch)(
        torch.zeros(3, dtype=torch.float64)).numpy()
    skew = np.zeros((3, 3, 3))
    skew[2, 1, 0], skew[1, 2, 0] = 1, -1  # d/dx
    skew[0, 2, 1], skew[2, 0, 1] = 1, -1  # d/dy
    skew[1, 0, 2], skew[0, 1, 2] = 1, -1  # d/dz
    np.testing.assert_array_equal(J, skew)


def test_projection_survives_rotation_roundtrip():
    cam = _random_ftheta(TC, 11)
    rot = TC.rotation_from_angle_axis(TC.angle_axis_from_rotation(cam.rotation))
    cam2 = cam._replace(rotation=rot)
    pt = (np.asarray(cam.position) + 3.1 * np.asarray(cam.forward)
          + np.array([0.5, -0.2, 0.1]))
    np.testing.assert_allclose(world_to_pixel(cam, pt), world_to_pixel(cam2, pt), atol=1e-6)


@pytest.mark.parametrize("case", [
    ([11, 12, -17], [-1, -1, 2], [-8, -4, 0], [3, 2, 1], [1, 2, 3], 1e-9),  # intersecting
    ([2, 2, 2], [-1, -1, 0], [0, 2, 0], [1, -1, 0], [1, 1, 1], 1e-9),  # skew
    ([2, 2, 2], [1, 2, 3], [1, 2, 3], [-1, -2, -3], [1.5, 2, 2.5], 1e-6),  # parallel
])
def test_ray_midpoint(case):
    oa, da, ob, db, expect, atol = case
    m = TC.ray_midpoint(oa, da, ob, db)
    np.testing.assert_allclose(m, expect, atol=atol)
    np.testing.assert_array_equal(m, JC.ray_midpoint(oa, da, ob, db))
