"""The port's ORB (surround360_tpu_torch/calib/orb.py) against OpenCV's,
stage by stage and whole, on the CPU.

OpenCV (``cv2``, in the test environment only) is the oracle: the
reference's ``match_keypoints`` calls ``cv2.ORB_create(nfeatures=4000)``.
Each stage is held to the OpenCV function it follows, bit for bit: grey
against cvtColor, every pyramid level against resize(INTER_LINEAR_EXACT),
FAST against FastFeatureDetector(20, nonmax), the angle against
fastAtan2, the descriptor blur against sepFilter2D with
getGaussianKernel(7, 2, CV_32F) (the float path GaussianBlur takes on
ORB's pyramid submatrix), and the test table against the bytes of
``bit_pattern_31_`` in the installed OpenCV library. Then the whole of
``detect_and_compute`` against ``detectAndCompute``: per-level counts,
every keypoint keyed by (level, float32 x, float32 y), every descriptor.
"""

import math
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke as cs
from surround360_tpu_torch.calib import orb
from surround360_tpu_torch.capture import render_camera_views
from surround360_tpu_torch.utils.math_util import fma_f32
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIDE = [f"cam{i}" for i in range(1, 7)]


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def scene():
    """tests/test_matches.py's scene: the 6-camera 120 deg ring at 0.25
    scale (512 px) under three sinusoids; {camera id: (3, H, W) RGB}."""
    rig = cs.reference_loop_rig()
    views = render_camera_views(rig, env_fn=cs.sinusoid_environment)
    return {cid: views[rig.ids.index(cid)][:3] for cid in SIDE}


def _to8(cv2, img):
    """The reference's to8 (surround360_tpu/calib/matches.py:43-53)."""
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = np.moveaxis(arr, 0, -1)
        if arr.shape[-1] >= 3:
            arr = cv2.cvtColor(arr[..., :3].astype(np.float32), cv2.COLOR_RGB2GRAY)
        else:
            arr = arr[..., 0]
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("shape,dtype", [((3, 512, 512), np.float32), ((3, 301, 417), np.float64),
                                         ((1, 97, 131), np.float64), ((64, 80), np.float32)])
def test_grey_equals_cvtcolor(cv2, shape, dtype):
    img = np.random.default_rng(1).uniform(-0.05, 1.05, shape).astype(dtype)
    np.testing.assert_array_equal(orb.to_gray8(img, "cpu").numpy(), _to8(cv2, img))


def test_grey_of_the_scene_equals_cvtcolor(cv2, scene):
    for cid, view in scene.items():
        np.testing.assert_array_equal(orb.to_gray8(view, "cpu").numpy(), _to8(cv2, view), cid)


@pytest.mark.parametrize("shape", [(512, 512), (2048, 2048), (600, 800), (301, 417), (97, 131)])
def test_every_pyramid_level_equals_resize_linear_exact(cv2, shape):
    """Each level from OpenCV's previous one, so a level is held alone;
    the edge outputs (clamped taps) included."""
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    sizes = orb._level_sizes(*shape)
    assert sizes[0] == shape and len(sizes) == orb.N_LEVELS
    prev = img
    for h, w in sizes[1:]:
        want = cv2.resize(prev, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
        got = orb._resize_linear_exact(torch.from_numpy(prev), h, w).numpy()
        np.testing.assert_array_equal(got, want, f"{shape} -> {(h, w)}")
        prev = want
    got = [lv.numpy() for lv in orb._pyramid(torch.from_numpy(img))]
    np.testing.assert_array_equal(got[-1], prev)


def test_fast_equals_opencv(cv2):
    img = np.random.default_rng(3).integers(0, 256, (240, 320)).astype(np.uint8)
    img[60:180, 80:240] //= 4  # a dark block: corners of both kinds
    want = {(int(k.pt[0]), int(k.pt[1]), k.response)
            for k in cv2.FastFeatureDetector_create(orb.FAST_THRESHOLD, True).detect(img)}
    score = orb._fast_scores(torch.from_numpy(img))
    ys, xs = torch.nonzero(score, as_tuple=True)
    got = {(int(x), int(y), float(score[y, x])) for y, x in zip(ys, xs)}
    assert len(want) > 1000
    assert got == want


def test_fast_atan2_equals_opencv(cv2):
    rng = np.random.default_rng(4)
    y = rng.integers(-300000, 300000, 20000).astype(np.float32)
    x = rng.integers(-300000, 300000, 20000).astype(np.float32)
    y[:100], x[50:150] = 0, 0  # the axes and the origin
    x[200:300] = y[200:300]  # the octant fold
    x[300:400] = -y[300:400]
    got = orb.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_fma_f32_rounds_once():
    """Against the exact value rounded to float32 (ties to even), and on a
    case where rounding through float64 first rounds twice."""
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in (1 + 2**-20, 1 - 2**-20, 16777218.0))
    assert fma_f32(a, b, c).item() == 16777218.0
    assert ((a.double() * b.double()) + c.double()).float().item() == 16777220.0

    def round_f32(x: Fraction) -> np.float32:
        f = np.float32(float(x))
        near = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
        odd = lambda v: int(np.array(v).view(np.int32)) & 1  # noqa: E731
        return min(near, key=lambda v: (abs(Fraction(float(v)) - x), odd(v)))

    rng = np.random.default_rng(5)
    A, B = rng.standard_normal((2, 2000)).astype(np.float32)
    C = (-(A.astype(np.float64) * B) * (1 + rng.standard_normal(2000) * 1e-6)).astype(np.float32)
    got = fma_f32(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C)).numpy()
    want = [round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
            for p, q, r in zip(A, B, C)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize("shape", [(512, 512), (300, 417), (600, 800), (97, 131)])
def test_blur_equals_opencv_float_path(cv2, shape):
    """ORB blurs each level in place on its pyramid's submatrix, which
    sends GaussianBlur past its bit-exact 8-bit path to sepFilter2D with
    float32 taps; the port's taps and blur equal that path's, and the
    bit-exact path (a whole image) differs from it."""
    taps = cv2.getGaussianKernel(7, orb.BLUR_SIGMA, cv2.CV_32F).ravel()
    np.testing.assert_array_equal(orb._gaussian_taps().numpy(), taps)
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    smooth = cv2.GaussianBlur(img, (0, 0), 1.5)  # gradients of every size
    for src in (img, smooth):
        want = cv2.sepFilter2D(src, cv2.CV_8U, taps, taps, borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(
            orb._blur(torch.from_numpy(src), orb._gaussian_taps()).numpy(), want)
    exact = cv2.GaussianBlur(img, (7, 7), 2, 2, borderType=cv2.BORDER_REFLECT_101)
    assert (exact != cv2.sepFilter2D(img, cv2.CV_8U, taps, taps,
                                     borderType=cv2.BORDER_REFLECT_101)).any()


def test_pattern_equals_opencv_table(cv2):
    """The 1024 int32 of bit_pattern_31_, found in the installed OpenCV
    library by their first eight values."""
    lib = [f for f in os.listdir(os.path.dirname(cv2.__file__))
           if f.startswith("cv2") and f.endswith(".so")]
    if not lib:
        pytest.skip("no OpenCV shared object beside cv2/__init__.py")
    with open(os.path.join(os.path.dirname(cv2.__file__), lib[0]), "rb") as f:
        data = f.read()
    table = orb.BIT_PATTERN_31.astype("<i4").tobytes()
    at = data.find(table[:32])
    assert at >= 0, "bit_pattern_31_ not found"
    assert data[at : at + 4096] == table


@pytest.mark.parametrize("case", ["noise", "cam1"])
def test_harris_and_angle_equal_opencv_keypoints(cv2, scene, case):
    """At each of OpenCV's keypoints, its ``response`` (the Harris score in
    float32) and ``angle`` (fastAtan2 of the integer moments) against the
    port's on the port's pyramid level."""
    u8 = (np.random.default_rng(9).integers(0, 256, (600, 800)).astype(np.uint8)
          if case == "noise" else _to8(cv2, scene[case]))
    kps = cv2.ORB_create(nfeatures=orb.N_FEATURES).detect(u8, None)
    levels = orb._pyramid(torch.from_numpy(u8))
    mask = torch.as_tensor(orb._patch_mask())
    for level in sorted({k.octave for k in kps}):
        ks = [k for k in kps if k.octave == level]
        inv = np.float32(1) / orb._level_scale(level)
        xs = torch.tensor([int(np.rint(np.float32(k.pt[0]) * inv)) for k in ks])
        ys = torch.tensor([int(np.rint(np.float32(k.pt[1]) * inv)) for k in ks])
        img = levels[level]
        np.testing.assert_array_equal(orb._harris(img, ys, xs).numpy(),
                                      np.array([k.response for k in ks], np.float32))
        np.testing.assert_array_equal(orb._angles(img, ys, xs, mask).numpy(),
                                      np.array([k.angle for k in ks], np.float32))


def _assert_equal_to_opencv(cv2, u8: np.ndarray):
    feats = orb.detect_and_compute(torch.from_numpy(u8))
    kps, des = cv2.ORB_create(nfeatures=orb.N_FEATURES).detectAndCompute(u8, None)
    want_levels = np.bincount([k.octave for k in kps], minlength=orb.N_LEVELS)
    got_levels = np.bincount(feats.octaves.numpy(), minlength=orb.N_LEVELS)
    np.testing.assert_array_equal(got_levels, want_levels)
    want = {(k.octave, np.float32(k.pt[0]), np.float32(k.pt[1])): d for k, d in zip(kps, des)}
    packed = np.packbits(feats.descriptors.numpy(), axis=1, bitorder="little")
    got = {(int(o), x, y): d for (x, y), o, d in zip(feats.points.numpy(),
                                                    feats.octaves.numpy(), packed)}
    assert len(got) == len(want) == len(kps) > 0
    assert got.keys() == want.keys()
    bad = [k for k in want if (got[k] != want[k]).any()]
    assert not bad, f"{len(bad)} of {len(want)} descriptors differ"
    assert feats.points.dtype == torch.float32


@pytest.mark.parametrize("shape", [(600, 800), (1024, 1024)])
def test_detect_and_compute_equals_opencv_on_noise(cv2, shape):
    _assert_equal_to_opencv(cv2, np.random.default_rng(7).integers(0, 256, shape).astype(np.uint8))


@pytest.mark.parametrize("cid", SIDE)
def test_detect_and_compute_equals_opencv_on_the_reference_scene(cv2, scene, cid):
    _assert_equal_to_opencv(cv2, _to8(cv2, scene[cid]))


def test_level_quotas_sum_to_the_features():
    quotas = orb._level_quotas(orb.N_FEATURES)
    assert sum(quotas) == orb.N_FEATURES and quotas[0] == 869
    assert orb._level_scale(1) == np.float32(math.pow(float(np.float32(1.2)), 1))
