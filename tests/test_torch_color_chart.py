"""The port's MacBeth chart detector (surround360_tpu_torch/calib/color.py::
detect_color_chart, no OpenCV) on the CPU: each stage against the OpenCV
function it replaces, on the six fixtures of tests/test_calib_color.py::
TestChartDetection, and the whole detector against the JAX package's.

OpenCV (``cv2``, in the test environment only) is the oracle here; the
port never imports it. Measured on the six fixtures, every stage is equal:
grey and its uint8 scaling, the fixed-point blur (0 pixels differ, where
+-1 would do), the adaptive threshold, the closing, the small-object
removal and component partition, the dilation, every border's points and
their order, the approximated polygons, convexity, contour areas, the
filled-quad masks, and minAreaRect's centres and sides within 1e-4 px
(OpenCV's float32 rotating calipers, ported). So the detector equals the JAX package's: the
same 24 patches in the same order, centroids within 1e-6 px and medians
within 1e-7 (both measured 0).

The repair: on a 2048 px frame where the chart is small (its geometry x
1.0, rotated 5 degrees, noise 0.01), the reference's detector also returns
the chart's own outline (25 patches, and its solve then fails); the port
drops quads that contain another candidate's centre and returns 24.
"""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_calib_color as reference_tests
from surround360_tpu.calib import color as J
from surround360_tpu_torch.calib import color as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = {
    "axis_aligned": {},
    "rotated": dict(rotation_deg=7.0),
    "perspective": dict(perspective=0.04),
    "noisy": dict(noise=0.02),
    "vignetted": dict(vignette=True),
    "combined": dict(rotation_deg=5.0, noise=0.015, vignette=True),
}
# TestChartDetection's bounds against the truth
TRUTH_TOL = {"rotated": 4.0, "perspective": 5.0, "vignetted": 4.0, "combined": 5.0}
CENTROID_TOL = 1e-6  # px, port vs JAX (measured 0)
MEDIAN_TOL = 1e-7  # port vs JAX (measured 0)
RECT_TOL = 1e-4  # px, minAreaRect centre and sides vs OpenCV's


@pytest.fixture(scope="module")
def charts():
    t = reference_tests.TestChartDetection()
    return {name: t._render_chart(**kw) for name, kw in FIXTURES.items()}


def _opencv_stages(chw):
    """detect_color_chart's OpenCV stages (surround360_tpu/calib/color.py
    :299-337)."""
    hwc = np.moveaxis(chw, 0, -1).astype(np.float32)
    H, W = hwc.shape[:2]
    out = {"hwc": hwc}
    grey = cv2.cvtColor(hwc, cv2.COLOR_RGB2GRAY)
    out["scaled"] = np.clip(2.0 * grey * 255.0, 0, 255).astype(np.uint8)
    out["blurred"] = cv2.GaussianBlur(out["scaled"], (15, 15), 0)
    out["threshold"] = cv2.adaptiveThreshold(
        out["blurred"], 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY_INV, 19, 2)
    min_area_patch = 5e-4 * H * W / 24
    radius = max(1, int(10.0 * min_area_patch / (H * W) * min(H, W)))
    out["radius"] = radius
    cross = cv2.getStructuringElement(cv2.MORPH_CROSS, (2 * radius + 1,) * 2)
    out["closed"] = cv2.morphologyEx(out["threshold"], cv2.MORPH_CLOSE, cross)
    _, labels, stats, _ = cv2.connectedComponentsWithStats(out["closed"])
    small = stats[:, cv2.CC_STAT_AREA] < 0.3 * min_area_patch
    out["cleaned"] = np.where(small[labels], 0, out["closed"]).astype(np.uint8)
    rect = cv2.getStructuringElement(cv2.MORPH_RECT, (2 * radius + 1,) * 2)
    out["dilated"] = cv2.dilate(out["cleaned"], rect)
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_pixel_stages_match_opencv(charts, name):
    """Each stage on OpenCV's input to it, and the port's own chain: equal."""
    ref = _opencv_stages(charts[name][0])
    t = torch.from_numpy
    r = ref["radius"]
    stages = [
        ("scaled", C.grey_u8(t(charts[name][0]))),
        ("blurred", C.gaussian_blur_u8(t(ref["scaled"]))),
        ("threshold", C.adaptive_threshold_inv(t(ref["blurred"]))),
        ("closed", C.close_cross(t(ref["threshold"]), r)),
        ("dilated", C.dilate_rect(t(ref["cleaned"]), r)),
    ]
    for stage, got in stages:
        got = got.numpy()
        assert got.dtype == np.uint8, stage
        assert int((got != ref[stage]).sum()) == 0, stage
    chain = C.close_cross(C.adaptive_threshold_inv(C.gaussian_blur_u8(
        C.grey_u8(t(charts[name][0])))), r).numpy()
    np.testing.assert_array_equal(chain, ref["closed"])


@pytest.mark.parametrize("name", FIXTURES)
def test_components_match_opencv(charts, name):
    """removeSmallObjects equal; the 8-connected partition, areas and
    bounding boxes equal up to the label numbering."""
    ref = _opencv_stages(charts[name][0])
    H, W = ref["closed"].shape
    cleaned = C.remove_small_objects(ref["closed"], 0.3 * 5e-4 * H * W / 24)
    np.testing.assert_array_equal(cleaned, ref["cleaned"])
    n, labels, stats, _ = cv2.connectedComponentsWithStats(ref["dilated"], 8)
    n_got, got, areas, widths, heights = C.connected_components(ref["dilated"])
    assert n_got == n
    pairs = np.unique(np.stack([labels.ravel(), got.ravel()]), axis=1)
    assert pairs.shape[1] == n  # one-to-one
    for a, b in pairs.T:
        if a == 0:
            assert b == 0
            continue
        assert (areas[b], widths[b], heights[b]) == (
            stats[a, cv2.CC_STAT_AREA], stats[a, cv2.CC_STAT_WIDTH],
            stats[a, cv2.CC_STAT_HEIGHT])


@pytest.mark.parametrize("name", FIXTURES)
def test_contour_geometry_matches_opencv(charts, name):
    """Per chart-sized component: findContours' borders (points and order,
    as a set of borders), approxPolyDP, and on the quads isContourConvex,
    moments m00, minAreaRect and drawContours(FILLED)."""
    ref = _opencv_stages(charts[name][0])
    H, W = ref["dilated"].shape
    n, labels, stats, _ = cv2.connectedComponentsWithStats(ref["dilated"], 8)
    quads = 0
    for lbl in range(1, n):
        if stats[lbl, cv2.CC_STAT_AREA] < 5e-4 * H * W:
            continue
        comp = (labels == lbl).astype(np.uint8) * 255
        conts, _ = cv2.findContours(comp, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
        mine = C.find_contours(comp > 0)
        assert len(mine) == len(conts)
        assert (sorted(c.reshape(-1, 2).tolist() for c in conts)
                == sorted(c.tolist() for c in mine))
        for c in conts:
            pts = c.reshape(-1, 2)
            assert C.arc_length(pts) == pytest.approx(cv2.arcLength(c, True), abs=1e-9)
            approx = cv2.approxPolyDP(c, 0.08 * cv2.arcLength(c, True), True)
            got = C.approx_poly_dp(pts, 0.08 * C.arc_length(pts))
            assert got.tolist() == approx.reshape(-1, 2).tolist()
            if len(got) != 4:
                continue
            quads += 1
            assert C.is_contour_convex(got) == cv2.isContourConvex(approx)
            assert C.contour_area(got) == cv2.moments(approx)["m00"]
            (cx, cy), (w, h), _ = cv2.minAreaRect(approx)
            centre, (w_got, h_got) = C.min_area_rect(got)
            np.testing.assert_allclose(centre, [cx, cy], rtol=0, atol=RECT_TOL)
            # the sides' order is OpenCV's angle convention; the detector
            # reads only the shorter and the longer side
            np.testing.assert_allclose(sorted([w_got, h_got]), sorted([w, h]), rtol=0,
                                       atol=RECT_TOL)
            mask = np.zeros((H, W), np.uint8)
            cv2.drawContours(mask, [approx], -1, 255, cv2.FILLED)
            (oy, ox), local = C.fill_quad(got, H, W)
            full = np.zeros((H, W), bool)
            full[oy:oy + local.shape[0], ox:ox + local.shape[1]] = local
            np.testing.assert_array_equal(full, mask > 0)
    assert quads >= 24


@pytest.mark.parametrize("name", FIXTURES)
def test_detector_matches_jax(charts, name):
    chw, truth, colors = charts[name]
    want_c, want_m = J.detect_color_chart(chw)
    got_c, got_m = C.detect_color_chart(chw, device="cpu")
    assert len(got_c) == len(want_c) == 24
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=CENTROID_TOL)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=MEDIAN_TOL)
    # TestChartDetection's own bounds
    np.testing.assert_allclose(got_c, truth, atol=TRUTH_TOL.get(name, 3.0))
    if name not in ("vignetted", "combined"):
        np.testing.assert_allclose(got_m, colors, atol=0.05 if name == "noisy" else 0.04)


def _large_chart(scale):
    colors = np.clip(cs.lab_to_rgb(C.LAB_MACBETH["D50"]), 0.03, 1.0)
    return cs.render_chart(colors, 2048, scale, rotation_deg=5.0, noise=0.01, seed=4)


def test_chart_outline_repair():
    """At 1.0x in a 2048 px frame the reference also returns the chart's
    outline (25 patches; its solve then fails on the shapes); the port
    returns the 24 patches and solves."""
    img, truth = _large_chart(1.0)
    want_c, want_m = J.detect_color_chart(img)
    assert len(want_c) == 25
    with pytest.raises(TypeError):
        J.solve_isp_color_params(want_m, want_c)
    got_c, got_m = C.detect_color_chart(img, device="cpu")
    assert len(got_c) == 24
    np.testing.assert_allclose(got_c, truth, atol=cs.CHART_CENT_TOL)
    # the outline is the reference's one extra quad; the 24 patches agree
    extra = [i for i, c in enumerate(want_c) if np.abs(got_c - c).max(axis=1).min() > 1e-6]
    assert len(extra) == 1
    assert np.abs(want_c[extra[0]] - [1023.5, 1023.5]).max() < 2.0
    result = C.solve_isp_color_params(got_m, got_c, device="cpu")
    assert np.isfinite(result.ccm).all()


def test_large_chart_matches_jax_where_it_finds_24():
    """At 1.5x (phase 21's scale) both packages find 24: equal outputs."""
    img, truth = _large_chart(1.5)
    want_c, want_m = J.detect_color_chart(img)
    got_c, got_m = C.detect_color_chart(img, device="cpu")
    assert len(want_c) == len(got_c) == 24
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=CENTROID_TOL)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=MEDIAN_TOL)
    np.testing.assert_allclose(got_c, truth, atol=cs.CHART_CENT_TOL)


def test_detect_cuda_default_raises_without_cuda(charts):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises((RuntimeError, AssertionError)):
        C.detect_color_chart(charts["axis_aligned"][0])
