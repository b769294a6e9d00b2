"""The port's geometric calibration (surround360_tpu_torch/calib/geometric.py)
against the JAX package's, on the CPU, and the reference's own cases
(tests/test_calib_geometric.py) on the port.

The JAX package runs its calibration in float32 (x64 is not enabled), the
port in float64, so the tolerances below are the float32 gap measured on
these inputs, not float64's: residuals differ by up to 5.1e-4 px (values
up to 323 px), Jc by 2.2e-4 of max(1, |J|), Jp by 9e-6; after
calibrate_geometric (3 passes x 10 iterations) the refined rows by 3.0e-7
rad in rotation, 1.7e-4 px in principal point, 8.3e-5 px in focal length
and 2.0e-7 in distortion (positions stay locked: equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import surround360_tpu.calib.geometric as JG
import surround360_tpu_torch.calib.geometric as TG
from surround360_tpu.geometry.rig import make_ring_rig as jax_ring_rig
from surround360_tpu_torch.calib import (
    CalibrationObservations,
    GeometricCalibrationConfig,
    calibrate_geometric,
    generate_artificial_points,
    perturb_rig,
    reprojection_report,
)
from surround360_tpu_torch.calib.geometric import reprojection_errors, triangulate_points
from surround360_tpu_torch.geometry.rig import make_ring_rig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
RES_TOL = 1e-3  # px; measured 5.1e-4
JC_TOL = 5e-4  # of max(1, |J|); measured 2.2e-4
JP_TOL = 1e-5  # measured 9.1e-6
ROT_TOL = 1e-6  # rad; measured 3.0e-7
PRINCIPAL_TOL = 5e-4  # px; measured 1.7e-4
FOCAL_TOL = 2e-4  # px; measured 8.3e-5
DISTORTION_TOL = 1e-6  # measured 2.0e-7


def _small(mod):
    # 6 side cameras with a wider fov keep the test fast while preserving
    # the overlap structure (the reference's fixture)
    return mod(num_side_cameras=6, side_fov_degrees=120.0)


@pytest.fixture(scope="module")
def small_rig():
    return _small(make_ring_rig)


@pytest.fixture(scope="module")
def recovery():
    """The reference's test_recovers_perturbed_rotations inputs, refined by
    both packages."""
    cfg = dict(passes=3, lm_iterations=10)
    obs, _ = generate_artificial_points(_small(make_ring_rig), 400, seed=4)
    bad = perturb_rig(_small(make_ring_rig), rotation_amount=0.005, principal_amount=2.0)
    refined, report = calibrate_geometric(bad, obs, GeometricCalibrationConfig(**cfg),
                                          device=CPU)
    jobs, _ = JG.generate_artificial_points(_small(jax_ring_rig), 400, seed=4)
    jbad = JG.perturb_rig(_small(jax_ring_rig), rotation_amount=0.005, principal_amount=2.0)
    jrefined, jreport = JG.calibrate_geometric(jbad, jobs, JG.GeometricCalibrationConfig(**cfg))
    return dict(obs=obs, bad=bad, refined=refined, report=report,
                jrefined=jrefined, jreport=jreport)


@pytest.mark.parametrize("num, seed, noise", [(300, 2, 0.0), (400, 5, 0.5)])
def test_synthetic_inputs_bit_equal(num, seed, noise):
    """The same seed draws the same observations and perturbations."""
    obs, world = generate_artificial_points(_small(make_ring_rig), num, seed=seed,
                                            noise_px=noise)
    jobs, jworld = JG.generate_artificial_points(_small(jax_ring_rig), num, seed=seed,
                                                 noise_px=noise)
    np.testing.assert_array_equal(world, jworld)
    for f in ("cam_idx", "pt_idx", "pixels"):
        np.testing.assert_array_equal(getattr(obs, f), getattr(jobs, f))
    assert obs.num_points == jobs.num_points
    bad = perturb_rig(_small(make_ring_rig), rotation_amount=0.005, seed=seed)
    jbad = JG.perturb_rig(_small(jax_ring_rig), rotation_amount=0.005, seed=seed)
    for c, j in zip(bad.cameras, jbad.cameras):
        np.testing.assert_array_equal(c.rotation, j.rotation)
        np.testing.assert_array_equal(c.principal, j.principal)


def test_triangulation_and_jacobians_match_jax(recovery):
    obs, bad = recovery["obs"], recovery["bad"]
    jbad = JG.perturb_rig(_small(jax_ring_rig), rotation_amount=0.005, principal_amount=2.0)
    pts = triangulate_points(bad, obs, CPU)
    jpts = JG.triangulate_points(jbad, obs)
    np.testing.assert_allclose(pts.numpy(), jpts, rtol=0, atol=1e-9)

    _, res_and_jac = JG._residuals_fn(jbad, obs)
    r, Jc, Jp = (np.asarray(x, np.float64) for x in res_and_jac(
        jnp.asarray(JG._rig_to_params(jbad)), jnp.asarray(jpts)))
    data = TG._Observations(bad, obs, torch.device(CPU))
    r2, Jc2, Jp2 = (x.numpy() for x in data.res_and_jac(
        torch.as_tensor(TG._rig_to_params(bad)), pts))
    assert np.abs(r2 - r).max() <= RES_TOL
    assert (np.abs(Jc2 - Jc) / np.maximum(1.0, np.abs(Jc2))).max() <= JC_TOL
    assert np.abs(Jp2 - Jp).max() <= JP_TOL
    np.testing.assert_allclose(
        reprojection_errors(bad, obs, pts, CPU).numpy(), np.linalg.norm(r2, axis=1),
        rtol=1e-12)


def test_calibration_matches_jax(recovery):
    rows = TG._rig_to_params(recovery["refined"])
    jrows = JG._rig_to_params(recovery["jrefined"])
    np.testing.assert_array_equal(rows[:, 0:3], jrows[:, 0:3])
    assert np.abs(rows[:, 3:6] - jrows[:, 3:6]).max() <= ROT_TOL
    assert np.abs(rows[:, 6:8] - jrows[:, 6:8]).max() <= PRINCIPAL_TOL
    assert np.abs(rows[:, 8] - jrows[:, 8]).max() <= FOCAL_TOL
    assert np.abs(rows[:, 9:11] - jrows[:, 9:11]).max() <= DISTORTION_TOL
    # the JAX package's float32 floor (~1e-4 px) against the port's float64
    assert recovery["report"]["rmse"] < 1e-9 < recovery["jreport"]["rmse"] < 1e-3


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_calib_geometric.py) on the port
# ---------------------------------------------------------------------------


def test_artificial_points_have_multiview_coverage(small_rig):
    obs, world = generate_artificial_points(small_rig, 300, seed=2)
    assert obs.num_points > 50
    counts = np.bincount(obs.pt_idx)
    assert counts.min() >= 2
    res = np.asarray(small_rig.cameras[0].resolution)
    assert (obs.pixels >= 0).all()
    assert (obs.pixels[:, 0] <= res[0]).all()


def test_ground_truth_rig_has_zero_error(small_rig):
    obs, world = generate_artificial_points(small_rig, 200, seed=3)
    pts = triangulate_points(small_rig, obs, CPU)
    errors = reprojection_errors(small_rig, obs, pts, CPU).numpy()
    assert np.median(errors) < 1e-3, np.median(errors)


def test_recovers_perturbed_rotations(small_rig, recovery):
    bad, obs = recovery["bad"], recovery["obs"]
    report_before = reprojection_report(
        reprojection_errors(bad, obs, triangulate_points(bad, obs, CPU), CPU))
    report_after = recovery["report"]
    assert report_after["rmse"] < 0.15 * report_before["rmse"], (report_before, report_after)
    for cam_t, cam_r in zip(small_rig.cameras, recovery["refined"].cameras):
        dot = float(np.dot(np.asarray(cam_t.forward), np.asarray(cam_r.forward)))
        assert dot > 0.99999, dot


def test_noise_floor_respected(small_rig):
    obs, _ = generate_artificial_points(small_rig, 400, seed=5, noise_px=0.5)
    bad = perturb_rig(small_rig, rotation_amount=0.003)
    cfg = GeometricCalibrationConfig(passes=2, lm_iterations=8)
    refined, report = calibrate_geometric(bad, obs, cfg, device=CPU)
    assert 0.2 < report["rmse"] < 1.5, report


@pytest.mark.parametrize("n", [500, 501])
def test_report_fields_match_jax(n):
    """The reference's report case, and the report equal to JAX's (np.median
    averages the two middle values of an even count; so does the port)."""
    errors = np.abs(np.random.default_rng(0).normal(size=n))
    rep = reprojection_report(errors)
    assert set(rep) == {"count", "rmse", "median", "p90", "p99", "worst"}
    assert rep["median"] <= rep["p90"] <= rep["p99"] <= rep["worst"]
    jrep = JG.reprojection_report(errors)
    for k in rep:
        assert rep[k] == pytest.approx(jrep[k], rel=1e-15, abs=0), k


def test_cull_reindexes_points():
    obs = CalibrationObservations(
        np.array([0, 1, 0, 2, 1], np.int32), np.array([0, 0, 1, 1, 2], np.int32),
        np.arange(10, dtype=np.float64).reshape(5, 2), 3)
    out = obs.cull(np.array([True, True, False, True, True]))
    # point 1 keeps one view and goes; point 2 had one view all along
    np.testing.assert_array_equal(out.cam_idx, [0, 1])
    np.testing.assert_array_equal(out.pt_idx, [0, 0])
    assert out.num_points == 1


# ---------------------------------------------------------------------------
# the reference's zero-rotation fault, and the port's repair
# ---------------------------------------------------------------------------


def test_zero_rotation_camera_jacobian_repaired():
    """On the real ring layout cam15's angle-axis is exactly 0. The JAX
    package's Jacobian is NaN in cam15's rows (the square root's derivative
    at 0 is taken before its guard), NaN times the lock mask stays NaN, and
    every LM step is rejected: its cost does not fall. The port's Jacobian
    is finite and its cost falls on the same inputs."""
    rig, jrig = make_ring_rig(), jax_ring_rig()
    obs, _ = generate_artificial_points(rig, 600, seed=0, noise_px=0.5)
    params = TG._rig_to_params(rig)
    assert np.linalg.norm(params[15, 3:6]) == 0.0
    free = np.ones((17, 11), bool)
    free[:, 0:3] = False
    free[0] = False
    cfg = GeometricCalibrationConfig(lm_iterations=1)

    jpts = JG.triangulate_points(jrig, obs)
    residuals_fn, res_and_jac = JG._residuals_fn(jrig, obs)
    _, Jc, _ = (np.asarray(x) for x in res_and_jac(jnp.asarray(params), jnp.asarray(jpts)))
    nan_rows = np.isnan(Jc).any(axis=(1, 2))
    assert nan_rows.any()
    np.testing.assert_array_equal(np.unique(obs.cam_idx[nan_rows]), [15])
    jcams, jpts2, jcost = JG._lm_solve(params, jpts, res_and_jac, residuals_fn, free,
                                       obs.cam_idx, obs.pt_idx, JG.GeometricCalibrationConfig(
                                           lm_iterations=1))
    np.testing.assert_array_equal(jcams, params)  # no step taken
    np.testing.assert_array_equal(jpts2, jpts)

    data = TG._Observations(rig, obs, torch.device(CPU))
    cams = torch.as_tensor(params)
    pts = triangulate_points(rig, obs, CPU)
    _, Jc2, Jp2 = data.res_and_jac(cams, pts)
    assert bool(torch.isfinite(Jc2).all()) and bool(torch.isfinite(Jp2).all())
    cost0 = TG._huber_cost(data.residuals(cams, pts), cfg)
    assert cost0 == pytest.approx(jcost, rel=1e-4)
    _, _, cost1, _ = TG._lm_solve(cams, pts, data, torch.as_tensor(free), cfg)
    assert cost1 < 0.9 * cost0, (cost0, cost1)


def test_sums_over_observations_in_observation_order():
    """The normal equations' sums add each index's rows in row order, as
    ``index_add_`` does on the CPU (on the card it adds by atomics; the
    port's sum sorts instead), so a calibration repeats bit for bit."""
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(0, 17, 5000))
    vals = torch.from_numpy(rng.standard_normal((5000, 11, 3)))
    want = torch.zeros(17, 11, 3, dtype=torch.float64).index_add_(0, idx, vals)
    assert torch.equal(TG._sum_into(17, idx, vals), want)
    one = torch.from_numpy(rng.standard_normal((5000, 3)))
    serial = torch.zeros(3, dtype=torch.float64)
    for row in one[idx.numpy() == 4]:
        serial = serial + row
    assert torch.equal(TG._sum_into(17, idx, one)[4], serial)
