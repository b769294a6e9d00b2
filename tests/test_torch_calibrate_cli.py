"""The port's calibration CLI (surround360_tpu_torch/cli/calibrate.py) on the
CPU against the JAX package's CLI (surround360_tpu/cli/calibrate.py): the
geometric sub-command's --unit_test and --matches_json routes, and the
vignetting sub-command, with the tolerances of the float32 gap measured in
tests/test_torch_calib_geometric.py and tests/test_torch_vignetting.py;
the built-in matcher's --frames_dir route against the library; the color
sub-command on two charts against the JAX CLI run with x64 enabled (ISP
JSONs within 1e-6: the detectors agree exactly and the solves are the
same float64 arithmetic; the JAX CLI's default float32 solve stops short
of that optimum on these charts) and its refusal
of a TIFF chart, which the reference reads with OpenCV; and --device cuda
(the default) raising without CUDA.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from surround360_tpu.cli import calibrate as jax_calibrate
from surround360_tpu_torch.calib.geometric import (
    GeometricCalibrationConfig,
    _rig_to_params,
    calibrate_geometric,
    generate_artificial_points,
    perturb_rig,
)
from surround360_tpu_torch.calib.matches import assemble_traces
from surround360_tpu_torch.capture import render_camera_views
from surround360_tpu_torch.cli import calibrate
from surround360_tpu_torch.cli.common import read_image_rgba, write_image
from surround360_tpu_torch.geometry.rig import load_rig, make_ring_rig, save_rig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROT_TOL = 1e-6  # rad (tests/test_torch_calib_geometric.py)
PRINCIPAL_TOL = 5e-4  # px
FOCAL_TOL = 2e-4  # px
DISTORTION_TOL = 1e-6
ROLLOFF_TOL = 1e-5  # tests/test_torch_vignetting.py
COLOR_JSON_TOL = 1e-6  # tests/test_torch_color.py's solve bound


def _small_rig():
    return make_ring_rig(num_side_cameras=6, side_fov_degrees=120.0)


def _assert_rigs_close(path, jax_path):
    rig, jrig = load_rig(path), load_rig(jax_path)
    rows, jrows = _rig_to_params(rig), _rig_to_params(jrig)
    np.testing.assert_array_equal(rows[:, 0:3], jrows[:, 0:3])  # positions locked
    # rotations as matrices: an angle-axis at pi may flip its sign
    assert max(np.abs(c.rotation - j.rotation).max()
               for c, j in zip(rig.cameras, jrig.cameras)) <= ROT_TOL
    assert np.abs(rows[:, 6:8] - jrows[:, 6:8]).max() <= PRINCIPAL_TOL
    assert np.abs(rows[:, 8] - jrows[:, 8]).max() <= FOCAL_TOL
    assert np.abs(rows[:, 9:11] - jrows[:, 9:11]).max() <= DISTORTION_TOL


def test_geometric_unit_test_matches_jax(tmp_path):
    rig_json = str(tmp_path / "rig.json")
    save_rig(rig_json, _small_rig())
    common = ["geometric", "--rig_json", rig_json, "--unit_test", "--num_points", "200",
              "--pass_count", "2"]
    calibrate.main(common + ["--output_json", str(tmp_path / "port.json"), "--device", "cpu"])
    jax_calibrate.main(common + ["--output_json", str(tmp_path / "jax.json")])
    _assert_rigs_close(str(tmp_path / "port.json"), str(tmp_path / "jax.json"))


def test_geometric_matches_json_matches_jax(tmp_path):
    """A matches.json made from a COLMAP database of artificial traces (each
    trace's views chained pairwise), refining a perturbed rig in both CLIs."""
    rig = _small_rig()
    rig_json = str(tmp_path / "rig.json")
    save_rig(rig_json, perturb_rig(rig, rotation_amount=0.005))
    obs, _ = generate_artificial_points(rig, 150, seed=8)
    keypoints, index, matches = {}, {}, {}
    for k, (c, p) in enumerate(zip(obs.cam_idx, obs.pt_idx)):
        kp = keypoints.setdefault(rig.ids[c], [])
        index[k] = len(kp)
        kp.append(obs.pixels[k])
    for p in range(obs.num_points):
        ks = np.nonzero(obs.pt_idx == p)[0]
        for a, b in zip(ks[:-1], ks[1:]):
            pair = (rig.ids[obs.cam_idx[a]], rig.ids[obs.cam_idx[b]])
            matches.setdefault(pair, []).append((index[a], index[b]))
    db = str(tmp_path / "features.db")
    cs.write_colmap_db(db, rig.ids, {k: np.asarray(v) for k, v in keypoints.items()},
                       [(a, b, np.asarray(m)) for (a, b), m in matches.items()])
    from surround360_tpu_torch.calib.matches import colmap_db_to_matches_json

    matches_json = str(tmp_path / "matches.json")
    colmap_db_to_matches_json(db, matches_json)
    common = ["geometric", "--rig_json", rig_json, "--matches_json", matches_json,
              "--pass_count", "2"]
    calibrate.main(common + ["--output_json", str(tmp_path / "port.json"), "--device", "cpu"])
    jax_calibrate.main(common + ["--output_json", str(tmp_path / "jax.json")])
    _assert_rigs_close(str(tmp_path / "port.json"), str(tmp_path / "jax.json"))


def test_geometric_frames_dir_equals_library(tmp_path):
    """The built-in matcher over <id>.png and <id>/<frame:06d>.png frames:
    the CLI's refined rig equals the library's on the same frames."""
    rig = _small_rig().rescaled(0.125)
    rig_json = str(tmp_path / "rig.json")
    save_rig(rig_json, rig)
    rig = load_rig(rig_json)
    frames = tmp_path / "frames"
    views = render_camera_views(rig, env_fn=lambda d: cs.calibration_environment(d, 8.0))
    for i, (cid, view) in enumerate(zip(rig.ids, views)):
        path = frames / cid / "000003.png" if i == 2 else frames / f"{cid}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_image(str(path), view)
    out = str(tmp_path / "refined.json")
    calibrate.main(["geometric", "--rig_json", rig_json, "--frames_dir", str(frames),
                    "--frame_number", "3", "--pass_count", "1", "--output_json", out,
                    "--device", "cpu"])
    images = {cid: read_image_rgba(str(frames / cid / "000003.png" if i == 2
                                       else frames / f"{cid}.png"))
              for i, cid in enumerate(rig.ids)}
    keypoints, matches = calibrate.match_frames(rig, images, "cpu")
    assert len(matches) >= 6
    obs = assemble_traces(keypoints, matches, {cid: i for i, cid in enumerate(rig.ids)})
    refined, _ = calibrate_geometric(rig, obs, GeometricCalibrationConfig(passes=1),
                                     device="cpu")
    # the same arithmetic; the CPU's threaded reductions may round apart
    np.testing.assert_allclose(_rig_to_params(load_rig(out)), _rig_to_params(refined),
                               rtol=0, atol=cs.CLI_AGREE)


def test_vignetting_matches_jax(tmp_path):
    sweep = str(tmp_path / "sweep")
    cs.write_vignetting_sweep(sweep, size=256, grid=6)
    port, jax = str(tmp_path / "port" / "isp.json"), str(tmp_path / "jax" / "isp.json")
    calibrate.main(["vignetting", "--sweep_dir", sweep, "--output_isp_json", port,
                    "--device", "cpu"])
    jax_calibrate.main(["vignetting", "--sweep_dir", sweep, "--output_isp_json", jax])
    with open(port) as f:
        got = json.load(f)["CameraIsp"]
    with open(jax) as f:
        want = json.load(f)["CameraIsp"]
    assert set(got) == set(want)
    for key in ("vignetteRollOffH", "vignetteRollOffV"):
        assert np.abs(np.asarray(got[key]) - np.asarray(want[key])).max() <= ROLLOFF_TOL
    for key in set(got) - {"vignetteRollOffH", "vignetteRollOffV"}:
        assert got[key] == want[key], key


def _color_json(path):
    with open(path) as f:
        isp = json.load(f)["CameraIsp"]
    return isp, np.concatenate([np.ravel(isp.pop(k)) for k in
                                ("blackLevel", "whiteBalanceGain", "ccm")])


def test_color_matches_jax(tmp_path):
    """Two 640 px charts of phase 21's kind (raw colours, rotated, with
    perspective, vignette and noise), through both CLIs."""
    charts = str(tmp_path / "charts")
    serials = cs.write_color_charts(charts, cameras=2, size=640)
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    calibrate.main(["color", "--charts_dir", charts, "--output_isp_dir", port,
                    "--device", "cpu"])
    import jax as jax_module

    with jax_module.enable_x64(True):
        jax_calibrate.main(["color", "--charts_dir", charts, "--output_isp_dir", jax])
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax)) == sorted(
        s + ".json" for s in serials)
    for s in serials:
        got, got_v = _color_json(os.path.join(port, s + ".json"))
        want, want_v = _color_json(os.path.join(jax, s + ".json"))
        assert got == want  # every other field of the base config
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=COLOR_JSON_TOL)
        # the black level, in units of the base config's 8-bit maximum
        np.testing.assert_allclose(got_v[:3] / 255.0, cs.CHART_BL, atol=0.02)


def test_color_tiff_chart_raises(tmp_path):
    """A .tif chart written by OpenCV: the reference reads it through
    OpenCV, the port through its own TIFF codec (it raised before the port
    read TIFF); both write the chart's JSON, equal within the solve's
    bound (the JAX CLI run with x64, as in test_color_matches_jax)."""
    import cv2
    import jax as jax_module

    charts = tmp_path / "charts"
    charts.mkdir()
    img, _ = cs.render_chart(cs.chart_raw_colors(), 640, 1.5, rotation_deg=3.0, seed=3)
    bgr = np.moveaxis(img, 0, -1)[..., ::-1]
    cv2.imwrite(str(charts / "cam0.tif"), (bgr * 65535 + 0.5).astype(np.uint16))
    with jax_module.enable_x64(True):
        jax_calibrate.main(["color", "--charts_dir", str(charts), "--output_isp_dir",
                            str(tmp_path / "jax")])
    calibrate.main(["color", "--charts_dir", str(charts), "--output_isp_dir",
                    str(tmp_path / "port"), "--device", "cpu"])
    got, got_v = _color_json(tmp_path / "port" / "cam0.json")
    want, want_v = _color_json(tmp_path / "jax" / "cam0.json")
    assert got == want
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=COLOR_JSON_TOL)


@pytest.mark.parametrize("sub", ["geometric", "vignetting", "color"])
def test_cuda_default_raises_without_cuda(tmp_path, sub):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    argv = {
        "geometric": ["geometric", "--rig_json", str(tmp_path / "rig.json"), "--unit_test"],
        "vignetting": ["vignetting", "--sweep_dir", str(tmp_path), "--output_isp_json",
                       str(tmp_path / "isp.json")],
        "color": ["color", "--charts_dir", str(tmp_path), "--output_isp_dir",
                  str(tmp_path / "isp.json")],
    }[sub]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.main(argv)
    assert not os.path.exists(tmp_path / "isp.json")
