"""The port's live preview against the JAX package's: the half-scale
demosaic, the alpha fades and the softmax blend, ``sees`` and the
equirect -> camera warp, ``PreviewRenderer`` and the preview CLI.

Scale as the reference's own preview test (tests/test_preview_dng.py):
``make_ring_rig().rescaled(0.125)`` (256 px cameras) and a 256x128
equirect. Elementwise image ops are held within 1e-6, the rendered
preview within 5e-5 (the dense bicubic remap sums its 16 taps in float32
in both packages), the warp within 1e-4 px with the same unseen mask.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surround360_tpu.geometry.camera as JC
import surround360_tpu.ops.compositing as JCO
import surround360_tpu_torch.geometry.camera as TC
import surround360_tpu_torch.ops.compositing as TCO
from surround360_tpu.capture import checker_sinusoid_environment, render_camera_views
from surround360_tpu.cli import preview as JPV
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig
from surround360_tpu.geometry.rig import save_rig
from surround360_tpu.isp.footage import write_footage_file
from surround360_tpu.isp.pipeline import IspConfig, bayer_masks
from surround360_tpu.isp.raw import pack_12bit_frame
from surround360_tpu.ops.warp import equirect_to_cam_warp as jax_warp
from surround360_tpu.render import preview as JP
from surround360_tpu_torch.cli import preview as TPV
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops.warp import equirect_to_cam_warp
from surround360_tpu_torch.render import preview as TP

CPU = torch.device("cpu")
EQR = dict(eqr_width=256, eqr_height=128)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def scene():
    """The rig at 256 px cameras and the three fisheye mosaics of the
    simulator's views, gamma undone so the preview's gamma restores them."""
    rig = jax_rig().rescaled(0.125)
    views = render_camera_views(rig)
    H, W = views[0].shape[-2:]
    red, green, _, _ = bayer_masks(IspConfig(bayer_pattern="GBRG"), H, W)

    def mosaic(v):
        lin = np.where(red, v[0], np.where(green, v[1], v[2])) ** (1 / 0.4545)
        return lin.astype(np.float32)

    idx = (rig.top_camera_index, rig.bottom_camera_index, rig.bottom_camera2_index)
    return rig, views, [mosaic(views[i]) for i in idx]


@pytest.mark.parametrize("pattern", ["GBRG", "GRBG", "RGGB", "BGGR"])
def test_simple_demosaic_matches_jax(pattern):
    raw = _rand((2, 16, 24), 1)
    want = np.asarray(JP.simple_demosaic(jnp.asarray(raw), 0.4545, pattern))
    got = TP.simple_demosaic(torch.from_numpy(raw), 0.4545, pattern)
    assert got.shape == (2, 3, 8, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        TP.simple_demosaic(torch.from_numpy(raw), 0.4545, "XXXX")


def test_fades_and_blend_match_jax():
    img = _rand((3, 4, 20, 30), 2)
    for name in ("radial_alpha_fade", "top_down_alpha_fade"):
        want = np.asarray(getattr(JCO, name)(jnp.asarray(img)))
        got = getattr(TCO, name)(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    img[1, 3, :5] = 0.0  # a layer with alpha 0 somewhere
    img[:, 3, -3:] = 0.0  # every layer transparent: den == 0
    want = np.asarray(JCO.flatten_layers_alpha_softmax(jnp.asarray(img), 5.0))
    got = TCO.flatten_layers_alpha_softmax(torch.from_numpy(img), 5.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    parts = [_rand((4, h, 7), h) for h in (3, 5)]
    np.testing.assert_array_equal(
        TCO.stack_vertical([torch.from_numpy(p) for p in parts]).numpy(),
        np.asarray(JCO.stack_vertical([jnp.asarray(p) for p in parts])))


def test_sees_matches_jax():
    jr, tr = jax_rig().rescaled(0.125), make_ring_rig().rescaled(0.125)
    pts = np.random.default_rng(3).normal(size=(400, 3)) * 1000.0
    for jc, tc in zip(jr.cameras, tr.cameras):
        want = np.asarray(JC.sees(jc, pts))
        got = TC.sees(tc, pts)
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TC.is_behind(tc, pts), np.asarray(JC.is_behind(jc, pts)))


def test_equirect_to_cam_warp_matches_jax():
    jr, tr = jax_rig().rescaled(0.125), make_ring_rig().rescaled(0.125)
    for i in (jr.top_camera_index, jr.bottom_camera_index, 3):
        want = jax_warp(jr.cameras[i], (64, 128), 1.0e6)
        got = equirect_to_cam_warp(tr.cameras[i], (64, 128), 1.0e6)
        assert got.dtype == np.float32 and got.shape == (2, 64, 128)
        unseen = want[0] == -1.0
        assert unseen.any() and not unseen.all()
        np.testing.assert_array_equal(got[0] == -1.0, unseen)
        np.testing.assert_array_equal(got[:, unseen], -1.0)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_preview_renderer_matches_jax(scene):
    rig, _, raws = scene
    want = np.asarray(JP.PreviewRenderer(rig, **EQR).render(*raws))
    pr = TP.PreviewRenderer(make_ring_rig().rescaled(0.125), **EQR, device=CPU)
    assert isinstance(pr, torch.nn.Module)
    assert pr.warps.shape == (3, 2, 128, 256) and pr.warps.device == CPU
    got = pr.render(*raws)
    assert got.shape == (3, 128, 256) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    # tensors are taken as they are
    again = pr.render(*[torch.from_numpy(r) for r in raws])
    assert torch.equal(again, got)


def test_preview_renderer_sees_the_environment(scene):
    """The reference's check: near both poles (rows 8 and 120 of 128) the
    preview is within 0.1 mean abs of the analytic environment."""
    _, _, raws = scene
    out = TP.PreviewRenderer(make_ring_rig().rescaled(0.125), **EQR,
                             device="cpu").render(*raws).numpy()
    assert np.isfinite(out).all()
    for y in (8, 120):
        phi = np.pi * (y + 0.5) / 128.0
        errs = []
        for x in range(0, 256, 16):
            theta = 2.0 * np.pi * (1.0 - (x + 0.5) / 256.0)
            d = np.array([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                          np.cos(phi)])
            errs.append(np.abs(out[:, y, x] - checker_sinusoid_environment(d)).mean())
        assert np.mean(errs) < 0.1, (y, np.mean(errs))


def test_preview_renderer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.PreviewRenderer(make_ring_rig().rescaled(0.125), **EQR)


def test_preview_cli_matches_jax_cli(tmp_path, scene):
    """Both CLIs on the same two .bin files (cameras round-robin over two
    consumers, serials in the rig's order): both JPEG sequences, decoded by
    OpenCV, agree at >= 40 dB."""
    rig, views, _ = scene
    H, W = views[0].shape[-2:]
    red, green, _, _ = bayer_masks(IspConfig(bayer_pattern="GBRG"), H, W)
    payloads = []
    for v in views:
        lin = np.where(red, v[0], np.where(green, v[1], v[2])) ** (1 / 0.4545)
        payloads.append(pack_12bit_frame(np.clip(lin * 4095 + 0.5, 0, 4095).astype(np.uint16)))
    serials = [100 + i for i in range(len(views))]
    os.makedirs(tmp_path / "bins")
    for cid in range(2):
        cams = [c for c in range(len(views)) if c % 2 == cid]
        write_footage_file(str(tmp_path / "bins" / f"{cid}.bin"),
                           [[payloads[c] for c in cams]] * 2, W, H, 12,
                           [serials[c] for c in cams], file_index=cid, file_count=2)
    save_rig(str(tmp_path / "rig.json"), rig)
    args = ["--binary_prefix", str(tmp_path / "bins"), "--file_count", "2",
            "--rig_json_file", str(tmp_path / "rig.json"), "--eqr_width", "256",
            "--eqr_height", "128", "--start_frame", "1"]
    JPV.main(args + ["--preview_dest", str(tmp_path / "j")])
    written = TPV.main(args + ["--preview_dest", str(tmp_path / "t"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["000001.jpg"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    a = cv2.imread(str(tmp_path / "j" / "000001.jpg")).astype(np.float64)
    b = cv2.imread(str(tmp_path / "t" / "000001.jpg")).astype(np.float64)
    assert a.shape == b.shape == (128, 256, 3)
    psnr = 10.0 * np.log10(255.0**2 / max(np.mean((a - b) ** 2), 1e-12))
    assert psnr >= 40.0, psnr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TPV.main(args + ["--preview_dest", str(tmp_path / "c")])
