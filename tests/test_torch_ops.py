"""Host geometry and image primitives of the PyTorch port against the JAX
package, on the same numpy-seeded inputs.

Host tables (camera model, warps, render context, simulator) are float64
numpy in both packages with the same operation order: they must be EQUAL.
Image primitives run in float32 on [0,1] data: max-abs 1e-5 (summation
order differs between XLA's CPU dots and torch's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surround360_tpu.capture.simulator as JS
import surround360_tpu.geometry.camera as JC
import surround360_tpu.ops.compositing as JCO
import surround360_tpu.ops.filters as JF
import surround360_tpu.ops.resize as JZ
import surround360_tpu.render.panorama as JP
import surround360_tpu_torch.capture.simulator as TS
import surround360_tpu_torch.geometry.camera as TC
import surround360_tpu_torch.ops.compositing as TCO
import surround360_tpu_torch.ops.filters as TF
import surround360_tpu_torch.ops.remap as TR
import surround360_tpu_torch.ops.resize as TZ
import surround360_tpu_torch.render.panorama as TP
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig
from surround360_tpu.ops.remap import remap as jax_remap
from surround360_tpu_torch.geometry.rig import load_rig, make_ring_rig, save_rig
from surround360_tpu_torch.utils.math_util import ramp

TOL = 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol)


@pytest.fixture(scope="module")
def rigs():
    return jax_rig().rescaled(0.125), make_ring_rig().rescaled(0.125)


def test_camera_model_equal(rigs):
    jr, tr = rigs
    rng = np.random.default_rng(1)
    pix = rng.uniform(0, 256, (50, 2))
    pts = rng.normal(size=(50, 3)) * 100.0
    for jc, tc in zip(jr.cameras, tr.cameras):
        for f in JC.Camera._fields:
            assert np.array_equal(getattr(jc, f), getattr(tc, f)), f
        assert np.array_equal(JC.world_to_pixel(jc, pts), TC.world_to_pixel(tc, pts))
        assert np.array_equal(
            JC.pixel_to_rig_direction(jc, pix), TC.pixel_to_rig_direction(tc, pix)
        )
        assert np.array_equal(
            JC.pixel_to_rig_near_infinity(jc, pix),
            TC.pixel_to_rig_near_infinity(tc, pix),
        )
        assert JC.get_fov(jc) == TC.get_fov(tc)
    # distortion round trip (undistort inverts distort)
    cam = TC.make_camera("RECTILINEAR", [0, 0, 0], [1, 0, 0], [0, 0, 1],
                         (64, 64), (40, -40), distortion=(0.1, -0.02))
    r = np.linspace(0.0, 0.8, 9)
    np.testing.assert_allclose(TC.undistort(cam, TC.distort(cam, r)), r, atol=1e-9)


def test_rig_json_round_trip(rigs, tmp_path):
    _, tr = rigs
    path = str(tmp_path / "rig.json")
    save_rig(path, tr)
    back = load_rig(path)
    assert back.ids == tr.ids and back.side_ids == tr.side_ids
    assert back.top_camera_index == tr.top_camera_index
    for a, b in zip(tr.cameras, back.cameras):
        np.testing.assert_allclose(a.rotation, b.rotation, atol=1e-12)
        np.testing.assert_allclose(a.focal, b.focal)


def test_render_context_tables_equal(rigs):
    jr, tr = rigs
    kw = dict(eqr_width=280, eqr_height=140, enable_top=True, enable_bottom=True)
    cj = JP.build_render_context(jr, JP.RenderConfig(**kw))
    ct = TP.build_render_context(tr, TP.RenderConfig(**kw))
    for f in ("side_warps", "top_warp", "bottom_warp", "warp_cols_l",
              "warp_cols_r", "t_cols"):
        assert np.array_equal(getattr(cj, f), getattr(ct, f)), f
    for f in ("strip_h", "strip_w", "h_radians", "v_radians", "overlap_w",
              "chunk_w", "zero_parallax_shift_px", "top_h", "bottom_h",
              "pole_ramp_geometry"):
        assert getattr(cj, f) == getattr(ct, f), f
    assert np.array_equal(
        JS.render_equirect_reference(cj, full_sphere=True),
        TS.render_equirect_reference(ct, full_sphere=True),
    )


def test_simulator_views_equal(rigs):
    jr, tr = rigs
    for a, b in zip(JS.render_camera_views(jr, image_size=48),
                    TS.render_camera_views(tr, image_size=48)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize(
    "shape,out",
    [((2, 3, 40, 56), (20, 28)), ((2, 3, 40, 56), (31, 77)),
     ((1, 2, 9, 1300), (9, 2600))],  # the last: polyphase 2x path
)
def test_resize_matches(shape, out):
    img = _img(shape)
    for jf, tf in ((JZ.resize_area, TZ.resize_area),
                   (JZ.resize_bilinear, TZ.resize_bilinear),
                   (JZ.resize_cubic, TZ.resize_cubic)):
        if jf is JZ.resize_area and out[1] > shape[-1]:
            continue
        _close(tf(torch.from_numpy(img), out), jf(jnp.asarray(img), out))
    if out[1] > shape[-1]:  # halving of a long axis (pairwise mean path)
        big = _img((1, 2, 4, 2600), 1)
        _close(TZ.resize_area(torch.from_numpy(big), (4, 1300)),
               JZ.resize_area(jnp.asarray(big), (4, 1300)))


@pytest.mark.parametrize("shape", [(2, 3, 40, 56), (1, 2, 30, 2600)])
def test_blur_and_filters_match(shape):
    img = _img(shape, 2)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    _close(TZ.gaussian_blur(t, 1.5), JZ.gaussian_blur(j, 1.5))
    _close(TZ.gaussian_blur(t, 8.0, ksize=15), JZ.gaussian_blur(j, 8.0, ksize=15))
    _close(TZ.pyramid_down(t), JZ.pyramid_down(j))
    _close(TF.iir_lowpass_2d(t, 0.25), JF.iir_lowpass_2d(j, 0.25))
    _close(
        TF.sharpen_iir(t, 1.25, h_boundary="wrap", v_boundary="reflect"),
        JF.sharpen_iir(j, 1.25, h_boundary="wrap", v_boundary="reflect"),
    )
    _close(TF.median_filter(t, 5), JF.median_filter(j, 5))
    _close(TF.median_filter_5x5_separable(t), JF.median_filter_5x5_separable(j))


def test_compositing_matches():
    a = _img((2, 4, 30, 48), 3)
    b = _img((2, 4, 30, 48), 4)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(TCO.feather_alpha(ta, 31), JCO.feather_alpha(ja, 31))
    _close(TCO.feather_alpha(ta, 3), JCO.feather_alpha(ja, 3))
    _close(TCO.flatten_layers_deghost_prefer_base(ta, tb),
           JCO.flatten_layers_deghost_prefer_base(ja, jb))
    _close(TCO.stack_horizontal([ta, tb]), JCO.stack_horizontal([ja, jb]))
    for off in (7.0, -3.25):
        _close(TCO.offset_horizontal_wrap(ta, off), JCO.offset_horizontal_wrap(ja, off))
    x = torch.linspace(-1, 3, 9)
    assert torch.equal(ramp(x, 0.0, 2.0), torch.clamp(x / 2.0, 0.0, 1.0))


@pytest.mark.parametrize("border", ["constant", "clamp", "wrap"])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_dense_remap_matches(interp, border):
    rng = np.random.default_rng(5)
    img = _img((2, 3, 24, 40), 6)
    gy, gx = np.meshgrid(np.arange(20), np.arange(36), indexing="ij")
    coords = np.stack([gx * 1.1 + rng.uniform(-4, 4, gx.shape),
                       gy * 1.2 + rng.uniform(-4, 4, gy.shape)]).astype(np.float32)
    coords = np.broadcast_to(coords, (2, 2, 20, 36)).copy()
    want = jax_remap(jnp.asarray(img), jnp.asarray(coords), interpolation=interp,
                     border=border, method="gather")
    _close(TR.remap(torch.from_numpy(img), torch.from_numpy(coords), interp, border), want)
