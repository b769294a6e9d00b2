"""Pole removal of the port against the JAX package, on the fixture of
tests/test_pole_removal.py (256 px cameras, a painted pole at other places
in the two bottom cameras), plus that file's quality assertions on the
port's own result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.capture import render_camera_views
from surround360_tpu.flow import make_flow_params as jax_flow_params
from surround360_tpu.geometry import camera as JCam
from surround360_tpu.geometry.rig import make_ring_rig as jax_ring_rig
from surround360_tpu.ops import compositing as JC
from surround360_tpu.render.pole import (
    combine_bottom_images_with_pole_removal as jax_combine,
)
from surround360_tpu_torch.flow import make_flow_params
from surround360_tpu_torch.geometry import camera as TCam
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops import compositing as TC
from surround360_tpu_torch.render.pole import combine_bottom_images_with_pole_removal

FEATHER = 9


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def test_alpha_cuts_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.random((2, 4, 37, 52)).astype(np.float32)
    mask = rng.random((37, 52)) > 0.7
    for radius in (5.0, 17.3, 100.0):
        got = TC.circle_alpha_cut(torch.from_numpy(img), radius).numpy()
        np.testing.assert_array_equal(got, np.asarray(JC.circle_alpha_cut(jnp.asarray(img), radius)))
    got = TC.cut_mask_out_of_alpha(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JC.cut_mask_out_of_alpha(jnp.asarray(img), jnp.asarray(mask))))
    assert np.all(got[:, 3][:, mask] == 0) and np.array_equal(got[:, :3], img[:, :3])


@pytest.mark.parametrize("scale", [1.0, 0.125, 0.03125])
def test_usable_radius_and_second_bottom_camera_equal_jax(scale):
    rig_j, rig_t = jax_ring_rig().rescaled(scale), make_ring_rig().rescaled(scale)
    assert rig_t.bottom_camera2_index == rig_j.bottom_camera2_index == 16
    assert rig_t.bottom_camera2_index != rig_t.bottom_camera_index
    for i in (rig_t.top_camera_index, rig_t.bottom_camera_index, rig_t.bottom_camera2_index):
        got = TCam.approximate_usable_pixels_radius(rig_t.cameras[i])
        assert got == JCam.approximate_usable_pixels_radius(rig_j.cameras[i])
        assert 0.45 * 2048 * scale < got <= 0.5 * 2048 * scale + 1e-6


@pytest.fixture(scope="module")
def fixture():
    rig = jax_ring_rig().rescaled(0.125)  # 256 px cameras
    views = render_camera_views(rig)
    cam1 = rig.cameras[rig.bottom_camera_index]
    cam2 = rig.cameras[rig.bottom_camera2_index]
    clean1 = np.array(views[rig.bottom_camera_index])
    clean2 = np.array(views[rig.bottom_camera2_index])
    H, W = clean1.shape[-2:]
    cy, cx = H // 2, W // 2

    def paint(img, y0, y1, x0, x1):
        img = img.copy()
        img[:3, y0:y1, x0:x1] = 0.05
        mask = np.zeros((H, W), bool)
        mask[y0:y1, x0:x1] = True
        return img, mask

    img1, mask1 = paint(clean1, cy - 24, cy + 24, cx - 20, cx + 20)
    img2, mask2 = paint(clean2, cy - 70, cy - 30, cx + 30, cx + 70)
    inner = np.zeros((H, W), bool)
    inner[cy - 12 : cy + 12, cx - 8 : cx + 8] = True
    flip180 = bool(np.dot(np.asarray(cam1.up), np.asarray(cam2.up)) < 0)
    assert flip180  # the ring rig mounts the second bottom camera turned round
    radii = (JCam.approximate_usable_pixels_radius(cam1),
             JCam.approximate_usable_pixels_radius(cam2))
    return dict(img1=img1, img2=img2, mask1=mask1, mask2=mask2, clean1=clean1,
                inner=inner, radii=radii, H=H, W=W)


def _both(fx, img2, mask2, flip180, prior=None):
    """(JAX (combined, flow), port (combined, flow)) as numpy."""
    jk, tk = {}, {}
    if prior is not None:
        names = ("prev_flow", "prev_bottom", "prev_bottom2")
        jk = dict(zip(names, map(jnp.asarray, prior)), use_temporal=True)
        tk = dict(zip(names, (torch.from_numpy(np.array(a)) for a in prior)),
                  use_temporal=True)
    want = jax_combine(
        jnp.asarray(fx["img1"]), jnp.asarray(img2), fx["mask1"], mask2, *fx["radii"],
        flip180, jax_flow_params("pixflow_tpu"), alpha_feather_size=FEATHER, **jk)
    got = combine_bottom_images_with_pole_removal(
        torch.from_numpy(fx["img1"]), torch.from_numpy(img2), fx["mask1"], mask2,
        *fx["radii"], flip180, make_flow_params("pixflow_tpu"),
        alpha_feather_size=FEATHER, **tk)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _held(want, got):
    """The flow by share of pixels off by > 0.1 px (its argmin flips on
    near-ties, tests/test_torch_flow.py), ``combined`` by mean and by the
    share of values off by > 1e-3 (the pixels those flips move)."""
    (jc, jf), (tc, tf) = want, got
    assert tc.shape == jc.shape and tf.shape == jf.shape == (2,) + jc.shape[-2:]
    assert np.isfinite(tc).all() and np.isfinite(tf).all()
    assert float((np.abs(tf - jf).max(axis=0) > 0.1).mean()) <= 0.01
    d = np.abs(tc - jc)
    assert float(d.mean()) <= 1e-4 and float((d > 1e-3).mean()) <= 0.01


@pytest.fixture(scope="module")
def results(fixture):
    return _both(fixture, fixture["img2"], fixture["mask2"], True)


def test_combine_matches_jax(results):
    _held(*results)


def test_combine_matches_jax_without_flip(fixture):
    """flip180 False on a secondary that was turned round beforehand (the
    alpha circle is cut before the flip and is not symmetric under it, so
    this is another input, not the same one): held to JAX's as above, and
    the pole region is refilled again."""
    img2 = np.ascontiguousarray(fixture["img2"][..., ::-1, ::-1])
    mask2 = np.ascontiguousarray(fixture["mask2"][::-1, ::-1])
    want, got = _both(fixture, img2, mask2, False)
    _held(want, got)
    assert got[0][3][fixture["mask1"]].min() > 0.9


def test_combine_with_temporal_prior_matches_jax(fixture, results):
    """The next frame, both packages from the JAX package's frame-0 state
    (as the CLI keeps it: the flow, the combined image, the raw secondary):
    within 1e-3, and the prior moves the port's flow."""
    (jc, jf), (_, tf0) = results
    want, got = _both(fixture, fixture["img2"], fixture["mask2"], True,
                      prior=(jf, jc, fixture["img2"]))
    _held(want, got)
    assert float(np.abs(got[0] - want[0]).max()) <= 1e-3
    assert float(np.abs(got[1] - tf0).max()) > 1e-3


def test_port_passes_the_quality_assertions(fixture, results):
    """tests/test_pole_removal.py's three assertions, on the port."""
    combined = results[1][0]
    assert combined[3][fixture["mask1"]].min() > 0.9  # refilled under the mask
    m = fixture["inner"]
    out = combined[:3][:, m]
    p_clean = psnr(out, fixture["clean1"][:3][:, m])
    assert p_clean > 35.0
    assert p_clean > psnr(out, fixture["img1"][:3][:, m]) + 20.0
    cy, cx = fixture["H"] // 2, fixture["W"] // 2
    sl = (slice(None), slice(cy + 40, cy + 70), slice(cx - 40, cx - 10))
    np.testing.assert_allclose(combined[:3][sl], fixture["img1"][:3][sl], atol=1e-3)


def test_warp_goes_through_the_window_kernel_wrapper(monkeypatch):
    """The secondary's warp is one call of the fused window sampler's
    wrapper (the kernel on a GPU, its twin here) labelled
    ``pole_removal_warp``, with the budgeted static plan's windows: 10 % of
    the frame as halos, every tap inside its window. The flow is labelled
    ``pole_removal_flow``."""
    from surround360_tpu_torch.ops import window_sampler as ws
    from surround360_tpu_torch.render import pole

    calls, flow_sites = [], []
    real_sample, real_flow = ws.fused_window_sample, pole.compute_flow

    def sample(padded, sy, sx, xt, yt, **kw):
        calls.append((tuple(padded.shape), tuple(xt.shape), kw))
        return real_sample(padded, sy, sx, xt, yt, **kw)

    def flow(*a, site="", **kw):
        flow_sites.append(site)
        return real_flow(*a, site=site, **kw)

    monkeypatch.setattr(ws, "fused_window_sample", sample)
    monkeypatch.setattr(pole, "compute_flow", flow)
    rng = np.random.default_rng(0)
    H = W = 96
    img = lambda: torch.from_numpy(rng.random((4, H, W), dtype=np.float32))
    mask = np.zeros((H, W), bool)
    mask[40:56, 42:54] = True
    combined, flow_out = combine_bottom_images_with_pole_removal(
        img(), img(), mask, np.zeros((H, W), bool), 46.0, 46.0, True,
        make_flow_params("pixflow_tpu"), alpha_feather_size=5)
    assert combined.shape == (4, H, W) and flow_out.shape == (2, H, W)
    assert flow_sites == ["pole_removal_flow"]
    (src, coords, kw), = calls
    plan = ws.plan_windows_budgeted((H, W), (H, W), 32, 32, "bicubic", "constant",
                                    16, 128, elems_per_px=4,
                                    max_window_elems=64 * 1024 * 1024)
    assert src == (1, 4, H, W) and coords == (plan.nty * plan.ntx, 1, plan.tr * plan.tc)
    assert kw["site"] == "pole_removal_warp" and (kw["bh"], kw["bw"]) == (plan.bh, plan.bw)
    assert (kw["interpolation"], kw["border"]) == ("bicubic", "constant")
