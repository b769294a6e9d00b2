"""Calibration on the card against the same calls on the CPU: the bundle
adjuster, its residuals and Jacobians, the ORB matcher and the vignetting
sweep, also in a fresh process that starts from torch's TF32 defaults; and
raw2rgb on the card reading a TIFF raw as it reads the PNG. Every case
needs CUDA and skips elsewhere; the file imports no JAX, so it runs on the
card's machine (README: the GPU pytest command)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from surround360_tpu_torch.calib import geometric as G
from surround360_tpu_torch.calib.orb import detect_and_compute, orb_match, to_gray8
from surround360_tpu_torch.capture import render_camera_views
from surround360_tpu_torch.calib.vignetting import acquire_vignetting_samples, fit_vignetting
from surround360_tpu_torch.geometry.rig import Rig, make_ring_rig


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _small_rig():
    return make_ring_rig(num_side_cameras=6, side_fov_degrees=120.0)


@pytest.mark.gpu
def test_bundle_adjustment_card_matches_cpu():
    """Rows within 1e-6 rad and 1e-4 px, the same observations kept; the
    residuals and Jacobians of the first iterate within 1e-9."""
    _cuda()
    rig = _small_rig()
    obs, _ = G.generate_artificial_points(rig, 400, seed=5, noise_px=0.5)
    bad = G.perturb_rig(rig, rotation_amount=0.003)
    jac = []
    for dev in ("cuda", "cpu"):
        data = G._Observations(bad, obs, torch.device(dev))
        params = torch.as_tensor(G._rig_to_params(bad), device=dev)
        jac.append([x.cpu().numpy() for x in data.res_and_jac(
            params, G.triangulate_points(bad, obs, dev))])
    for a, b in zip(*jac):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    cfg = G.GeometricCalibrationConfig(passes=2, lm_iterations=8)
    card, card_rep = G.calibrate_geometric(bad, obs, cfg, device="cuda")
    cpu, cpu_rep = G.calibrate_geometric(bad, obs, cfg, device="cpu")
    assert max(np.abs(c.rotation - p.rotation).max()
               for c, p in zip(card.cameras, cpu.cameras)) <= 1e-6
    a, b = G._rig_to_params(card), G._rig_to_params(cpu)
    assert np.abs(a[:, 6:9] - b[:, 6:9]).max() <= 1e-4
    assert card_rep["count"] == cpu_rep["count"]


@pytest.mark.gpu
def test_bundle_adjustment_repeats_bit_for_bit_on_card():
    """Two runs on the card on the same inputs give the same rig: the sums
    over observations do not go through atomics (a last-bit difference
    would move the culls between passes)."""
    _cuda()
    rig = _small_rig()
    obs, _ = G.generate_artificial_points(rig, 400, seed=6, noise_px=0.5)
    bad = G.perturb_rig(rig, rotation_amount=0.003)
    cfg = G.GeometricCalibrationConfig(passes=3, lm_iterations=8)
    runs = [G._rig_to_params(G.calibrate_geometric(bad, obs, cfg, device="cuda")[0])
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])


def _texture():
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(np.random.default_rng(0).random((300, 400)), 1.5)
    base = (base - base.min()) / (base.max() - base.min())
    return base[:, 20:320].astype(np.float32), base[:, 10:310].astype(np.float32)


def _assert_card_equals_cpu(grey_u8: torch.Tensor):
    """detect_and_compute on the card and on the CPU: positions,
    descriptors and levels equal bit for bit, in the same order."""
    card = detect_and_compute(grey_u8.cuda())
    cpu = detect_and_compute(grey_u8.cpu())
    assert len(cpu.points) > 0
    for name, a, b in zip(cpu._fields, card, cpu):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


@pytest.mark.gpu
def test_orb_card_matches_cpu():
    """The shifted-texture case on the card: its bounds, the grey levels
    and the matches the CPU's, and every keypoint and descriptor the CPU's."""
    _cuda()
    a, b = _texture()
    pts_a, pts_b = orb_match(a[None], b[None], device="cuda")
    assert len(pts_a) > 20
    assert abs(np.median(pts_b[:, 0] - pts_a[:, 0]) - 10.0) < 1.0
    cpu_a, cpu_b = orb_match(a[None], b[None], device="cpu")
    np.testing.assert_array_equal(np.sort(pts_a, 0), np.sort(cpu_a, 0))
    np.testing.assert_array_equal(np.sort(pts_b, 0), np.sort(cpu_b, 0))
    grey = to_gray8(a, "cpu")
    assert torch.equal(to_gray8(a, "cuda").cpu(), grey)
    _assert_card_equals_cpu(grey)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [f"cam{i}" for i in range(1, 7)] + ["noise2048"])
def test_orb_features_card_equal_cpu(case):
    """detect_and_compute on the card equals the CPU's bit for bit on
    tests/test_matches.py's 512 px sinusoid scene (each side camera, its
    RGB grey taken on each device) and on a 2048 x 2048 noise image."""
    _cuda()
    if case == "noise2048":
        grey = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2048, 2048),
                                                                   dtype=np.uint8))
    else:
        rig = cs.reference_loop_rig()
        i = rig.ids.index(case)
        view = render_camera_views(Rig([rig.cameras[i]], [case], ["side camera"]),
                                   env_fn=cs.sinusoid_environment)[0][:3]
        grey = to_gray8(view, "cpu")
        assert torch.equal(to_gray8(view, "cuda").cpu(), grey)
    _assert_card_equals_cpu(grey)


@pytest.mark.gpu
def test_vignetting_card_matches_cpu():
    _cuda()
    rng = np.random.default_rng(3)
    n = 256
    yy, xx = np.mgrid[:n, :n]
    imgs = []
    for cx in (40, 90, 140, 200):
        for cy in (40, 100, 160, 215):
            img = 0.2 + 0.01 * rng.standard_normal((n, n))
            img[(abs(xx - cx) <= 12) & (abs(yy - cy) <= 12)] += 0.6 * (1 - 0.3 * (cx / n - 0.5) ** 2)
            imgs.append(img.astype(np.float32))
    out = [acquire_vignetting_samples(imgs, device=d) for d in ("cuda", "cpu")]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=1e-7)
    fits = [fit_vignetting(*out[1], (n, n), device=d) for d in ("cuda", "cpu")]
    np.testing.assert_allclose(fits[0].rolloff_h, fits[1].rolloff_h, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fits[0].rolloff_v, fits[1].rolloff_v, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_orb_and_vignetting_from_torch_defaults():
    """The ORB and vignetting cases in a fresh process where nothing set
    the TF32 flags first (torch lets cuDNN run float32 convolutions in
    TF32 by default): the library turns TF32 off itself, so the card still
    equals the CPU within the same bounds."""
    _cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "assert torch.backends.cudnn.allow_tf32, 'torch default'\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_calib_card as t\n"
        "t.test_orb_card_matches_cpu()\n"
        "t.test_vignetting_card_matches_cpu()\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.gpu
def test_raw2rgb_tiff_raw_on_card_equals_png(tmp_path):
    import json

    from surround360_tpu_torch.cli import common, raw2rgb
    from surround360_tpu_torch.cli.tiff import write_tiff
    from surround360_tpu_torch.isp.pipeline import IspConfig

    _cuda()
    raw = np.random.default_rng(7).integers(0, 65536, (256, 320, 1)).astype(np.uint16)
    write_tiff(str(tmp_path / "raw.tif"), raw)
    common.write_png(str(tmp_path / "raw.png"), raw)
    isp = tmp_path / "isp.json"
    isp.write_text(json.dumps(IspConfig(bayer_pattern="GBRG", bits_per_pixel=12).to_json()))
    outs = []
    for ext in ("tif", "png"):
        out = str(tmp_path / f"rgb_{ext}.png")
        raw2rgb.main(["--input_image_path", str(tmp_path / f"raw.{ext}"),
                      "--output_image_path", out, "--isp_config_path", str(isp),
                      "--output_bpp", "16"])
        outs.append(common.read_png(out))
    np.testing.assert_array_equal(outs[0], outs[1])
