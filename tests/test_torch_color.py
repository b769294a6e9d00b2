"""The port's colour solve and colour tables (surround360_tpu_torch/calib/
color.py) on the CPU against the JAX package's (surround360_tpu/calib/
color.py) on the same numpy inputs, and the reference tests' own checks on
the port.

Tolerances: the JAX package computes in float32 (nothing enables x64), the
port in float64. Run under JAX_ENABLE_X64 the reference's solve moves by at
most 4.1e-8 (black level), 4.8e-8 (white balance) and 3.8e-7 (CCM) on
these observations, and the port sits at the same distances, so the solve
is held within 1e-6. Lab values: the port's float64 path against the
reference run with x64 enabled within 1e-9 (measured 5.7e-14), its float32
path against the reference's float32 within 1e-4 (measured 5.7e-5: a and b
are 500 and 200 times a difference of cube roots); DeltaE within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from surround360_tpu.calib import color as J
import test_calib_color as reference_tests
from surround360_tpu_torch.calib.color import (
    LAB_MACBETH,
    build_color_adjustment_model,
    delta_e_report,
    rgb_to_lab,
    solve_isp_color_params,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOLVE_TOL = 1e-6
LAB_TOL = 1e-9  # float64 against the reference in x64
LAB32_TOL = 1e-4  # float32 against the reference's float32
DELTA_E_TOL = 1e-4


@pytest.mark.parametrize("illuminant", ["D50", "D65"])
def test_rgb_to_lab_matches_jax(illuminant):
    rng = np.random.default_rng(0)
    rgb = np.concatenate([rng.random((64, 3)), [[0, 0, 0], [1, 1, 1], [0.005, 0.2, 0.9]]])
    with jax.enable_x64(True):
        want = np.asarray(J.rgb_to_lab(rgb, illuminant))
    assert want.dtype == np.float64
    np.testing.assert_allclose(rgb_to_lab(rgb, illuminant), want, rtol=0, atol=LAB_TOL)
    got = rgb_to_lab(torch.as_tensor(rgb), illuminant)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LAB_TOL)
    got32 = rgb_to_lab(torch.as_tensor(rgb, dtype=torch.float32), illuminant)
    np.testing.assert_allclose(got32.numpy(), np.asarray(J.rgb_to_lab(rgb, illuminant)),
                               rtol=0, atol=LAB32_TOL)


def test_rgb_to_lab_jacobian_is_finite_below_the_knee():
    """The linear branch (t <= 0.008856, black included) takes the
    derivative of its own expression; the clamped cube root keeps the
    other branch's derivative finite."""
    rgb = torch.tensor([[0.0, 0.0, 0.0], [0.001, 0.002, 0.0005], [0.5, 0.4, 0.3]],
                       dtype=torch.float64)
    jac = torch.func.jacfwd(lambda x: rgb_to_lab(x, "D50"))(rgb)
    assert torch.isfinite(jac).all()


# the reference tests' own checks (tests/test_calib_color.py::TestLab)
def test_white_point():
    lab = rgb_to_lab(np.array([1.0, 1.0, 1.0]), "D50")
    assert abs(lab[0] - 100.0) < 0.5
    assert abs(lab[1]) < 1.0 and abs(lab[2]) < 1.0


def test_black():
    assert abs(rgb_to_lab(np.array([0.0, 0.0, 0.0]), "D65")[0]) < 1e-5


def test_roundtrip():
    rgb = np.random.default_rng(0).random((10, 3)) * 0.9 + 0.05
    back = reference_tests.lab_to_rgb(rgb_to_lab(rgb, "D50"), "D50")
    np.testing.assert_allclose(back, rgb, atol=1e-5)


_SOLVE_CASES = {"recovers": (1, False), "black_level": (2, False), "locked": (3, True)}


@pytest.fixture(scope="module")
def solves():
    """TestColorSolve's three observation sets through both packages."""
    out = {}
    for name, (seed, lock) in _SOLVE_CASES.items():
        obs, cents, M, bl = reference_tests.TestColorSolve()._make_observations(seed=seed)
        kw = dict(black_level=bl) if lock else {}
        out[name] = (J.solve_isp_color_params(obs, cents, "D50", **kw),
                     solve_isp_color_params(obs, cents, "D50", device="cpu", **kw), M, bl)
    return out


@pytest.mark.parametrize("case", list(_SOLVE_CASES))
def test_solve_matches_jax(solves, case):
    ref, got, _, _ = solves[case]
    for field in ("black_level", "white_balance", "ccm"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field),
                                   rtol=0, atol=SOLVE_TOL, err_msg=field)
    assert got.final_cost < 1.0 and ref.final_cost < 1.0


@pytest.mark.parametrize("case", list(_SOLVE_CASES))
def test_solve_recovers_truth(solves, case):
    """TestColorSolve's checks on the port: WB x CCM maps grey to grey, CCM
    rows sum to 1, the black level is recovered (or kept when locked)."""
    _, got, M, bl = solves[case]
    grey = got.ccm @ (got.white_balance * (np.linalg.inv(M) @ np.ones(3)))
    np.testing.assert_allclose(grey / grey.mean(), 1.0, atol=0.02)
    np.testing.assert_allclose(got.ccm.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.black_level, bl, atol=1e-9 if case == "locked" else 0.02)


def test_solve_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    obs, cents, _, _ = reference_tests.TestColorSolve()._make_observations()
    with pytest.raises((RuntimeError, AssertionError)):
        solve_isp_color_params(obs, cents)


@pytest.mark.parametrize("illuminant,corrupt", [("D65", False), ("D50", True)])
def test_delta_e_report_matches_jax(illuminant, corrupt):
    rgb = reference_tests.lab_to_rgb(LAB_MACBETH[illuminant], illuminant)
    if corrupt:
        rgb[:, 0] *= 1.3
    ref, got = J.delta_e_report(rgb, illuminant), delta_e_report(rgb, illuminant)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["per_patch"], ref["per_patch"], rtol=0, atol=DELTA_E_TOL)
    for key in ("mean", "median", "max"):
        assert abs(got[key] - ref[key]) <= DELTA_E_TOL
    # TestDeltaE's checks
    assert got["mean"] > 3.0 if corrupt else got["max"] < 0.01


def test_delta_e_median_of_an_even_count():
    """np.median semantics: the mean of the two middle DeltaEs."""
    rgb = reference_tests.lab_to_rgb(LAB_MACBETH["D50"], "D50")[:4]
    rgb = rgb * [[1.0], [1.1], [1.2], [1.3]]
    rep = delta_e_report(rgb, "D50")
    assert rep["median"] == pytest.approx(float(np.median(rep["per_patch"])), abs=1e-12)


@pytest.mark.parametrize("sample_rate,opaque_share", [(4, 1.0), (100, 1.0), (4, 0.001)])
def test_color_adjustment_model_matches_jax(sample_rate, opaque_share):
    """The same samples drawn in the same order: equal coefficients (the
    sparse-alpha case takes every opaque pixel); and TestColorAdjustmentModel's
    recovery of an affine shift."""
    rng = np.random.default_rng(7)
    base = rng.random((3, 64, 64)).astype(np.float32) * 0.8
    alpha = (rng.random((1, 64, 64)) < opaque_share).astype(np.float32)
    alpha[0, :3, :3] = 1.0
    target = np.concatenate([base, alpha])
    shifted = base + np.array([0.05, -0.03, 0.02], np.float32)[:, None, None]
    adjust = np.concatenate([shifted, np.ones((1, 64, 64), np.float32)])
    ref = J.build_color_adjustment_model(target, adjust, sample_rate=sample_rate)
    got = build_color_adjustment_model(target, adjust, sample_rate=sample_rate)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    if opaque_share == 1.0:
        np.testing.assert_allclose(np.array([1.0, 0.5, 0.5, 0.5]) @ got,
                                   [-0.05, 0.03, -0.02], atol=0.01)
