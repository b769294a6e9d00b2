"""The port's JPEG codec, its compare tool and its flow visualizations
against OpenCV (the JAX package's image codec) and the JAX package.

OpenCV is the reference decoder and encoder here: the port's files must
decode in OpenCV within 1 dB of OpenCV's own quality-95 encode of the same
image, and the port's decoder must read OpenCV's files (4:2:0, 4:4:4,
grey, restart intervals) at >= 40 dB against OpenCV's decode.
"""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.cli import common as JCOM
from surround360_tpu.cli import compare as JCMP
from surround360_tpu.flow import visualization as JV
from surround360_tpu_torch.cli import common as TCOM
from surround360_tpu_torch.cli import compare as TCMP
from surround360_tpu_torch.cli import jpeg as TJ
from surround360_tpu_torch.flow import visualization as TV


def _image(h, w, c, seed):
    """Smooth colour structure plus noise, (h, w, c) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 6.0 + k) * np.cos(y / 10.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * np.log10(255.0**2 / max(mse, 1e-12))


def _cv2_read(path, grey):
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if grey else cv2.IMREAD_COLOR)
    return img[..., None] if grey else img[..., ::-1]


def _segments(path):
    """marker -> payloads of the header segments up to the scan."""
    blob, pos, out = open(path, "rb").read(), 2, {}
    while pos < len(blob):
        marker, n = blob[pos + 1], int.from_bytes(blob[pos + 2 : pos + 4], "big")
        out.setdefault(marker, []).append(blob[pos + 4 : pos + 2 + n])
        pos += 2 + n
        if marker == 0xDA:
            return out
    return out


@pytest.mark.parametrize("shape", [(37, 53, 3), (128, 256, 3), (45, 70, 1)],
                         ids=["colour-odd", "colour", "grey-odd"])
def test_jpeg_writer_decodes_in_cv2_like_cv2s_own(tmp_path, shape):
    img = _image(*shape, seed=shape[0])
    grey = shape[-1] == 1
    port, ref = str(tmp_path / "port.jpg"), str(tmp_path / "cv2.jpg")
    TJ.write_jpeg(port, img)
    cv2.imwrite(ref, img[..., 0] if grey else np.ascontiguousarray(img[..., ::-1]),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    got, want = _cv2_read(port, grey), _cv2_read(ref, grey)
    assert got.shape == img.shape
    assert _psnr(got, img) >= _psnr(want, img) - 1.0
    # what OpenCV writes by default: the same tables, frame and scan headers
    seg_p, seg_c = _segments(port), _segments(ref)
    for marker in (0xDB, 0xC4, 0xC0, 0xDA):
        assert seg_p[marker] == seg_c[marker], hex(marker)


CV2_FILES = {
    "420": [],
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "optimized-q60": [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 60],
    "grey": [],
    "grey-restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
}


@pytest.mark.parametrize("case", list(CV2_FILES))
def test_jpeg_reader_reads_cv2_files(tmp_path, case):
    grey = case.startswith("grey")
    img = _image(45, 70, 1 if grey else 3, seed=7)
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, img[..., 0] if grey else np.ascontiguousarray(img[..., ::-1]),
                CV2_FILES[case])
    got = TJ.read_jpeg(path)
    want = _cv2_read(path, grey)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert _psnr(got, want) >= 40.0


def test_jpeg_reader_refuses_progressive_and_garbage(tmp_path):
    img = _image(32, 40, 3, seed=8)
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="SOF2 \\(progressive"):
        TJ.read_jpeg(path)
    (tmp_path / "n.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match="not a JPEG"):
        TJ.read_jpeg(str(tmp_path / "n.jpg"))
    TJ.write_jpeg(path, img)
    blob = open(path, "rb").read()
    (tmp_path / "t.jpg").write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ValueError):
        TJ.read_jpeg(str(tmp_path / "t.jpg"))


def test_image_io_dispatches_on_extension(tmp_path):
    """write_image / read_image_rgba: .jpg and .jpeg through the port's
    codec (alpha dropped on write, 1 on read), the same arrays the JAX
    package's OpenCV reader returns for the file up to decoder rounding;
    .tiff through the port's TIFF codec, read as the JAX package reads it;
    any other extension raises naming its format."""
    img = _image(24, 40, 4, seed=9).astype(np.float32).transpose(2, 0, 1) / 255.0
    for name in ("a.jpg", "b.JPEG"):
        path = str(tmp_path / name)
        TCOM.write_image(path, img)
        got = TCOM.read_image_rgba(path)
        assert got.shape == (4, 24, 40) and got.dtype == np.float32
        assert np.all(got[3] == 1.0)
        want = JCOM.read_image_rgba(path)
        assert np.abs(got - want).max() <= 3.0 / 255.0
        assert _psnr(got[:3] * 255, img[:3] * 255) > 30.0
    TCOM.write_image(str(tmp_path / "g.jpg"), img[:1])
    g = TCOM.read_image_rgba(str(tmp_path / "g.jpg"))
    assert np.array_equal(g[0], g[1]) and np.array_equal(g[0], g[2])
    TCOM.write_image(str(tmp_path / "x.tiff"), img, bit_depth=16)
    np.testing.assert_array_equal(TCOM.read_image_rgba(str(tmp_path / "x.tiff")),
                                  JCOM.read_image_rgba(str(tmp_path / "x.tiff")))
    with pytest.raises(ValueError, match="unsupported image format '.bmp'"):
        TCOM.write_image(str(tmp_path / "x.bmp"), img)
    with pytest.raises(ValueError, match="not supported for JPEG"):
        TCOM.write_image(str(tmp_path / "x.jpg"), img, bit_depth=16)


def _write_pair_dirs(tmp_path, write, ext):
    """The reference's compare case (tests/test_cli.py): two frames and a
    noisy copy of each."""
    rng = np.random.default_rng(9)
    a_dir, b_dir = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
    a_dir.mkdir()
    b_dir.mkdir()
    for i in range(2):
        img = rng.random((3, 16, 24)).astype(np.float32)
        write(str(a_dir / f"{i:06d}{ext}"), img)
        noisy = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1).astype(np.float32)
        write(str(b_dir / f"{i:06d}{ext}"), noisy)
    return str(a_dir), str(b_dir)


def test_compare_dirs_matches_jax(tmp_path):
    a, b = _write_pair_dirs(tmp_path, TCOM.write_image, ".png")
    rep = TCMP.compare_dirs(a, b)
    assert rep["frames"] == 2
    assert 30.0 < rep["psnr_mean_db"] < 50.0
    assert rep == JCMP.compare_dirs(a, b)  # PNG: the same arrays, the same numbers
    a, b = _write_pair_dirs(tmp_path, TCOM.write_image, ".jpg")
    rep, want = TCMP.compare_dirs(a, b), JCMP.compare_dirs(a, b)
    for name, row in rep["per_frame"].items():
        assert abs(row["psnr_db"] - want["per_frame"][name]["psnr_db"]) <= 0.5


def test_compare_identical_dirs_and_exit_code(tmp_path):
    d = tmp_path / "same"
    d.mkdir()
    img = np.random.default_rng(10).random((3, 8, 8)).astype(np.float32)
    TCOM.write_image(str(d / "x.png"), img)
    assert TCMP.compare_dirs(str(d), str(d))["psnr_min_db"] > 100.0
    a, b = _write_pair_dirs(tmp_path, TCOM.write_image, ".png")
    report = str(tmp_path / "report.json")
    TCMP.main(["--dir_a", a, "--dir_b", b, "--report", report, "--min_psnr_db", "20"])
    assert json.load(open(report))["frames"] == 2
    with pytest.raises(SystemExit) as e:
        TCMP.main(["--dir_a", a, "--dir_b", b, "--min_psnr_db", "60"])
    assert e.value.code == 1
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no common image files"):
        TCMP.compare_dirs(str(d), str(tmp_path / "empty"))


def test_flow_visualizations_match_jax():
    flow = np.random.default_rng(11).normal(0, 3, (2, 20, 30)).astype(np.float32)
    for fn, kw in (("visualize_flow_disparity", {}), ("visualize_flow_disparity",
                                                     {"max_disparity": 2.0}),
                   ("visualize_flow_color_wheel", {}),
                   ("visualize_flow_color_wheel", {"max_mag": 4.0})):
        want = getattr(JV, fn)(flow, **kw)
        for arg in (flow, torch.from_numpy(flow), jnp.asarray(flow)):
            got = getattr(TV, fn)(arg, **kw)
            assert got.dtype == np.float32 and got.shape == (3, 20, 30)
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=fn)
    np.testing.assert_allclose(TV.color_wheel_legend(64), JV.color_wheel_legend(64),
                               atol=1e-6)
