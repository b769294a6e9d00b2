"""TIFF in the port's image codecs (``cli/tiff.py`` through
``cli/common.py``) against the JAX package's OpenCV reader and writer.

Files written by ``cv2.imwrite`` for every compression OpenCV writes
(none, LZW, Adobe Deflate, PackBits, Deflate; libtiff adds the horizontal
predictor to LZW and Deflate), 8 and 16 bits, grey, RGB and RGBA, read by
the port's ``read_image_rgba`` equal to the JAX package's (max-abs 0); a
tiled file and big-endian files built here by hand; the unsupported
cases raise naming their tag; the port's writer read back by the JAX
reader; raw2rgb, compare and calibrate color on TIFF inputs. The card's
machine has no OpenCV, so the tests that need it skip there.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from surround360_tpu.cli import common as JC  # noqa: E402
from surround360_tpu.cli import compare as JCMP  # noqa: E402
from surround360_tpu_torch.cli import common as TC  # noqa: E402
from surround360_tpu_torch.cli import compare as TCMP  # noqa: E402
from surround360_tpu_torch.cli import raw2rgb as TR2  # noqa: E402
from surround360_tpu_torch.cli.tiff import read_tiff, write_tiff  # noqa: E402
from surround360_tpu_torch.isp import pipeline as TISP  # noqa: E402

COMPRESSIONS = {"none": 1, "lzw": 5, "adobe_deflate": 8, "packbits": 32773, "deflate": 32946}
SHAPE = (70, 61)  # several strips at every depth and channel count


def _samples(channels, dtype, seed=0):
    """A ramp with noise (runs for PackBits, repeats for LZW)."""
    hi = np.iinfo(dtype).max
    ramp = np.linspace(0, hi, SHAPE[1])[None, :, None] * np.ones(SHAPE + (channels,))
    noise = np.random.default_rng(seed).integers(0, 4, ramp.shape)
    return np.clip(ramp + noise, 0, hi).astype(dtype)


def _to_cv2(hwc):
    if hwc.shape[-1] == 1:
        return hwc[..., 0]
    return hwc[..., [2, 1, 0, 3][: hwc.shape[-1]]]


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
@pytest.mark.parametrize("compression", list(COMPRESSIONS))
def test_opencv_tiffs_read_as_jax_reads_them(tmp_path, compression, dtype, channels):
    hwc = _samples(channels, dtype)
    path = str(tmp_path / "img.tif")
    assert cv2.imwrite(path, _to_cv2(hwc),
                       [cv2.IMWRITE_TIFF_COMPRESSION, COMPRESSIONS[compression]])
    np.testing.assert_array_equal(read_tiff(path), hwc)
    got, want = TC.read_image_rgba(path), JC.read_image_rgba(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() == 0


def _tiff(hwc, bo="<", tile=None, compression=1, predictor=1, tags=None, version=42):
    """A one-image TIFF built by hand: strips of 16 rows or square tiles of
    ``tile`` px, the samples differenced horizontally with predictor 2,
    compressed with zlib (8) or stored (1); ``tags`` override entries."""
    H, W, C = hwc.shape
    dtype = hwc.dtype.newbyteorder(bo)

    def encode(block):
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = np.diff(block, axis=1)  # wraps in the sample type
        raw = block.astype(dtype).tobytes()
        return zlib.compress(raw) if compression == 8 else raw

    if tile:
        ty, tx = -(-H // tile), -(-W // tile)
        padded = np.zeros((ty * tile, tx * tile, C), hwc.dtype)
        padded[:H, :W] = hwc
        chunks = [encode(padded[y * tile:(y + 1) * tile, x * tile:(x + 1) * tile])
                  for y in range(ty) for x in range(tx)]
    else:
        chunks = [encode(hwc[y:y + 16]) for y in range(0, H, 16)]
    offsets, at = [], 8
    for c in chunks:
        offsets.append(at)
        at += len(c)
    entries = {256: (4, [W]), 257: (4, [H]), 258: (3, [8 * hwc.itemsize] * C),
               259: (3, [compression]), 262: (3, [1 if C == 1 else 2]), 277: (3, [C]),
               284: (3, [1]), 317: (3, [predictor])}
    if tile:
        entries.update({322: (3, [tile]), 323: (3, [tile]), 324: (4, offsets),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (4, offsets), 278: (3, [16]), 279: (4, [len(c) for c in chunks])})
    entries.update(tags or {})
    ifd_at = at + at % 2
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = [struct.pack(bo + "H", len(entries))], b""
    for tag in sorted(entries):
        typ, values = entries[tag]
        blob = struct.pack(f"{bo}{len(values)}{'H' if typ == 3 else 'I'}", *values)
        if len(blob) > 4:
            ifd.append(struct.pack(bo + "HHII", tag, typ, len(values), extra_at + len(extra)))
            extra += blob
        else:
            ifd.append(struct.pack(bo + "HHI", tag, typ, len(values)) + blob.ljust(4, b"\0"))
    ifd.append(struct.pack(bo + "I", 0))
    head = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", version, ifd_at)
    return head + b"".join(chunks) + b"\0" * (at % 2) + b"".join(ifd) + extra


@pytest.mark.parametrize("case", [
    dict(tile=16, compression=8, predictor=2),
    dict(tile=32, compression=1),
    dict(bo=">", compression=1),
    dict(bo=">", compression=8, predictor=2),
    dict(bo=">", tile=16, compression=8, predictor=2),
], ids=["tiled-deflate-predictor", "tiled", "big-endian", "big-endian-deflate-predictor",
        "big-endian-tiled"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
def test_hand_built_tiffs(tmp_path, case, dtype):
    """Tiles (padded at the right and bottom edges) and big-endian files
    read equal to their arrays, and to OpenCV's reading of them."""
    hwc = _samples(3, dtype, seed=1)[:37, :29]
    path = tmp_path / "img.tif"
    path.write_bytes(_tiff(hwc, **case))
    np.testing.assert_array_equal(read_tiff(str(path)), hwc)
    assert np.abs(TC.read_image_rgba(str(path)) - JC.read_image_rgba(str(path))).max() == 0


@pytest.mark.parametrize("tags, version, match", [
    ({259: (3, [7])}, 42, r"Compression \(259\) = 7"),  # JPEG-in-TIFF
    ({339: (3, [3, 3, 3]), 258: (3, [32, 32, 32])}, 42, r"SampleFormat \(339\) = 3"),
    ({339: (3, [2, 2, 2])}, 42, r"SampleFormat \(339\) = 2"),
    ({284: (3, [2])}, 42, r"PlanarConfiguration \(284\) = 2"),
    ({}, 43, r"BigTIFF"),
    ({258: (3, [1, 1, 1])}, 42, r"BitsPerSample \(258\) = 1"),
    ({258: (3, [12, 12, 12])}, 42, r"BitsPerSample \(258\) = 12"),
    ({262: (3, [3])}, 42, r"PhotometricInterpretation \(262\) = 3"),
    ({317: (3, [3])}, 42, r"Predictor \(317\) = 3"),
], ids=["jpeg", "float", "signed", "planar", "bigtiff", "1bit", "12bit", "palette",
        "float-predictor"])
def test_unsupported_tiffs_raise_naming_the_tag(tmp_path, tags, version, match):
    path = tmp_path / "img.tif"
    path.write_bytes(_tiff(_samples(3, np.uint8)[:20, :20], tags=tags, version=version))
    with pytest.raises(ValueError, match=match):
        TC.read_image_rgba(str(path))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("bit_depth", [8, 16])
def test_written_tiff_reads_equal_in_jax(tmp_path, channels, bit_depth):
    img = np.random.default_rng(channels).random((channels, 23, 37)).astype(np.float32)
    path = str(tmp_path / "t.tif")
    TC.write_image(path, img, bit_depth=bit_depth)
    assert np.abs(TC.read_image_rgba(path) - JC.read_image_rgba(path)).max() == 0
    plain = str(tmp_path / "plain.tiff")
    scale = 255 if bit_depth == 8 else 65535
    write_tiff(plain, np.clip(np.moveaxis(img, 0, -1) * scale + 0.5, 0, scale)
               .astype(np.uint8 if bit_depth == 8 else np.uint16), compress=False)
    assert np.abs(TC.read_image_rgba(plain) - TC.read_image_rgba(path)).max() == 0


def _isp_json(tmp_path):
    cfg = TISP.IspConfig(bayer_pattern="GBRG", bits_per_pixel=12,
                         black_level=(40.0, 48.0, 56.0), white_balance_gain=(1.2, 1.0, 1.5))
    path = tmp_path / "isp.json"
    path.write_text(json.dumps(cfg.to_json()))
    return str(path)


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
def test_raw2rgb_reads_a_tiff_raw_as_the_png(tmp_path, channels):
    """A 16-bit mosaic as TIFF (LZW with the predictor, as OpenCV writes by
    default) and as PNG: the same RGB out; of a colour raw, the blue
    channel (the reference's raw[..., 0] of BGR)."""
    raw = np.random.default_rng(5).integers(0, 65536, (48, 64, channels)).astype(np.uint16)
    isp = _isp_json(tmp_path)
    cv2.imwrite(str(tmp_path / "raw.tif"), _to_cv2(raw))
    TC.write_png(str(tmp_path / "raw.png"), raw)
    outs = []
    for ext in ("tif", "png"):
        out = str(tmp_path / f"rgb_{ext}.png")
        TR2.main(["--input_image_path", str(tmp_path / f"raw.{ext}"), "--output_image_path",
                  out, "--isp_config_path", isp, "--output_bpp", "16", "--device", "cpu"])
        outs.append(TC.read_png(out))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_compare_reads_tiff_pairs_as_jax(tmp_path):
    rng = np.random.default_rng(6)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        img = rng.random((3, 30, 40)).astype(np.float32)
        JC.write_image(str(tmp_path / "a" / f"{i}.tiff"), img, bit_depth=16)
        TC.write_image(str(tmp_path / "b" / f"{i}.tiff"),
                       np.clip(img + 0.01 * rng.standard_normal(img.shape), 0, 1), bit_depth=16)
    got = TCMP.compare_dirs(str(tmp_path / "a"), str(tmp_path / "b"))
    want = JCMP.compare_dirs(str(tmp_path / "a"), str(tmp_path / "b"))
    assert got["frames"] == want["frames"] == 2
    assert got["psnr_mean_db"] == pytest.approx(want["psnr_mean_db"], abs=1e-9)
    assert got["psnr_min_db"] == pytest.approx(want["psnr_min_db"], abs=1e-9)


def test_calibrate_color_takes_tiff_charts(tmp_path):
    """calibrate color on a chart as .tif writes the JSON it writes for the
    same chart as .png."""
    import chip_smoke as cs
    from surround360_tpu_torch.cli import calibrate

    png_dir, tif_dir = tmp_path / "png", tmp_path / "tif"
    cs.write_color_charts(str(png_dir), cameras=1, size=640)
    os.makedirs(tif_dir)
    for name in os.listdir(png_dir):
        img = TC.read_png(str(png_dir / name))
        write_tiff(str(tif_dir / (os.path.splitext(name)[0] + ".tif")), img)
    outs = []
    for d in (png_dir, tif_dir):
        out = tmp_path / f"isp_{d.name}"
        calibrate.main(["color", "--charts_dir", str(d), "--output_isp_dir", str(out),
                        "--device", "cpu"])
        outs.append({n: json.loads((out / n).read_text()) for n in sorted(os.listdir(out))})
    assert outs[0] and outs[0] == outs[1]
