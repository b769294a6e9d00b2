"""The port's vignetting calibration (surround360_tpu_torch/calib/vignetting.py)
against the JAX package's, on the CPU, and the reference's surface case
(tests/test_calib_color.py::TestVignetting) on the port.

The JAX fit runs in float32, the port's in float64: on the reference's
surface case the rolloff control points differ by at most 6.6e-7 and the
Bezier points by 2.3e-6, hence 1e-5 and 1e-5 below. The acquisition is
held to the JAX package's (OpenCV's GaussianBlur and minMaxLoc):
locations exact, intensities within 1e-6 (both are float32 medians of the
same patch; np.median averages in float32, the port in float64).
"""

import numpy as np
import pytest

import surround360_tpu.calib.vignetting as JV
from surround360_tpu_torch.calib.vignetting import (
    acquire_vignetting_samples,
    fit_vignetting,
)
from surround360_tpu_torch.utils.math_util import bezier_curve_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROLLOFF_TOL = 1e-5  # measured 6.6e-7
BEZIER_TOL = 1e-5  # measured 2.3e-6


def _surface_samples():
    rng = np.random.default_rng(5)
    W, H = 640, 480
    locs = rng.random((120, 2)) * [W - 1, H - 1]
    u = locs[:, 0] / 640
    v = locs[:, 1] / 640
    surface = (1.0 - 0.5 * (u - 0.5) ** 2) * (1.0 - 0.4 * (v - 0.35) ** 2) * 0.7
    return locs, np.stack([surface] * 3, axis=1), (W, H)


@pytest.fixture(scope="module")
def fits():
    locs, intensities, size = _surface_samples()
    return (fit_vignetting(locs, intensities, size, device="cpu"),
            JV.fit_vignetting(locs, intensities, size))


def test_fit_matches_jax(fits):
    fit, jfit = fits
    assert np.abs(fit.rolloff_h - jfit.rolloff_h).max() <= ROLLOFF_TOL
    assert np.abs(fit.rolloff_v - jfit.rolloff_v).max() <= ROLLOFF_TOL
    assert np.abs(fit.bezier_x - jfit.bezier_x).max() <= BEZIER_TOL
    assert np.abs(fit.bezier_y - jfit.bezier_y).max() <= BEZIER_TOL
    assert fit.rolloff_h.shape == jfit.rolloff_h.shape == (5, 3)


def test_fit_recovers_surface(fits):
    """The reference's case: the fitted gain curve inverts the surface."""
    fit, _ = fits
    assert fit.rms_residual < 0.01, fit.rms_residual
    ts = np.linspace(0.0, (640 - 1) / 640, 33)
    product = bezier_curve_batch(fit.rolloff_h[:, 0], ts) * bezier_curve_batch(
        fit.bezier_x[0], ts)
    assert product.std() / product.mean() < 0.01, product


def _sweep(n=256, frames=8, seed=3):
    """A grey target (25 px square) at random places on a dim, noisy
    background, float32 planes as the CLI reads them."""
    rng = np.random.default_rng(seed)
    imgs, truth = [], []
    yy, xx = np.mgrid[:n, :n]
    for _ in range(frames):
        cx, cy = (int(v) for v in rng.integers(6, n - 6, size=2))
        img = 0.2 + 0.01 * rng.standard_normal((n, n))
        img[(abs(xx - cx) <= 12) & (abs(yy - cy) <= 12)] += 0.6
        imgs.append(img.astype(np.float32))
        truth.append((cx, cy))
    return imgs, truth


def test_acquisition_matches_jax():
    """Brightest point after OpenCV's sigma-5 blur (first maximum in raster
    order), patches clipped at 0 on the near edges only; targets near the
    borders included."""
    imgs, truth = _sweep()
    locs, intensities = acquire_vignetting_samples(imgs, device="cpu")
    jlocs, jintensities = JV.acquire_vignetting_samples(imgs)
    np.testing.assert_array_equal(locs, jlocs)
    np.testing.assert_allclose(intensities, jintensities, rtol=0, atol=1e-6)
    # a target cut by the frame's edge peaks at the edge (reflected border)
    truth = np.asarray(truth)
    inside = ((truth >= 13) & (truth < 256 - 13)).all(1)
    assert 0 < inside.sum() < len(truth)
    assert np.abs(locs[inside] - truth[inside]).max() <= 1


def test_acquisition_with_chart_locations_matches_jax():
    imgs, truth = _sweep(frames=4, seed=4)
    charts = [(x + 0.5, y - 0.25) for x, y in truth]
    locs, intensities = acquire_vignetting_samples(imgs, charts=charts, device="cpu")
    jlocs, jintensities = JV.acquire_vignetting_samples(imgs, charts=charts)
    np.testing.assert_array_equal(locs, jlocs)
    np.testing.assert_allclose(intensities, jintensities, rtol=0, atol=1e-6)
