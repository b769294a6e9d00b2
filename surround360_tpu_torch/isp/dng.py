"""Minimal DNG (TIFF/EP) writer for raw Bayer frames.

Port of ``surround360_tpu/isp/dng.py`` (reference: the writeDng path of
surround360_render/source/camera_isp/Raw2Rgb.cpp :69-331) — a hand-rolled
single-IFD TIFF with the DNG CFA tags and the CCM-derived ColorMatrix1
(CCM -> XYZ D50), so raw mosaics drop into standard raw developers.
Tag constants per source/camera_isp/DngTags.h. The bytes written equal
the reference package's, the camera model and software strings included.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_dng"]

# TIFF/DNG tags (DngTags.h:20-99)
T_NEW_SUBFILE_TYPE = 254
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_MAKE = 271
T_MODEL = 272
T_STRIP_OFFSETS = 273
T_ORIENTATION = 274
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_SOFTWARE = 305
T_CFA_REPEAT_PATTERN_DIM = 33421
T_CFA_PATTERN = 33422
T_DNG_VERSION = 50706
T_DNG_BACKWARD_VERSION = 50707
T_UNIQUE_CAMERA_MODEL = 50708
T_CFA_PLANE_COLOR = 50710
T_CFA_LAYOUT = 50711
T_BLACK_LEVEL = 50714
T_WHITE_LEVEL = 50717
T_COLOR_MATRIX_1 = 50721
T_AS_SHOT_NEUTRAL = 50728
T_CALIBRATION_ILLUMINANT_1 = 50778

TYPE_BYTE = 1
TYPE_ASCII = 2
TYPE_SHORT = 3
TYPE_LONG = 4
TYPE_SRATIONAL = 10

# sRGB(D65 primaries) -> XYZ(D50-adapted) like the reference's
# conversion of the CCM into ColorMatrix1 (Raw2Rgb.cpp writeDng)
_RGB2XYZ_D50 = np.array(
    [
        [0.4360747, 0.3850649, 0.1430804],
        [0.2225045, 0.7168786, 0.0606169],
        [0.0139322, 0.0971045, 0.7141733],
    ]
)

_CFA_BYTES = {
    # DNG CFAPattern: 0=R 1=G 2=B, row major over the 2x2 tile
    "RGGB": bytes([0, 1, 1, 2]),
    "GRBG": bytes([1, 0, 2, 1]),
    "GBRG": bytes([1, 2, 0, 1]),
    "BGGR": bytes([2, 1, 1, 0]),
}


def write_dng(
    path: str,
    raw16: np.ndarray,  # (H, W) uint16 mosaic
    bayer_pattern: str = "GBRG",
    ccm: np.ndarray | None = None,
    white_balance: tuple = (1.0, 1.0, 1.0),
    black_level: int = 0,
    white_level: int = 65535,
    camera_model: str = "surround360-tpu",
) -> None:
    raw16 = np.ascontiguousarray(raw16, dtype="<u2")
    H, W = raw16.shape

    # ColorMatrix1 is XYZ -> camera-RGB: inv(RGB2XYZ @ inv(CCM))
    ccm = np.eye(3) if ccm is None else np.asarray(ccm, dtype=np.float64)
    cam2xyz = _RGB2XYZ_D50 @ np.linalg.inv(ccm)
    color_matrix = np.linalg.inv(cam2xyz)

    def srational_block(values, denom=10000):
        out = b""
        for v in values:
            out += struct.pack("<2i", int(round(v * denom)), denom)
        return out

    entries = []  # [tag, type, count, value bytes]

    def add(tag, typ, count, data):
        entries.append([tag, typ, count, data])

    make = b"surround360\0"
    model = camera_model.encode() + b"\0"
    cfa = _CFA_BYTES[bayer_pattern.upper()[:4]]
    neutral = srational_block([1.0 / max(g, 1e-6) for g in white_balance])
    cm = srational_block(color_matrix.reshape(-1))

    add(T_NEW_SUBFILE_TYPE, TYPE_LONG, 1, struct.pack("<I", 0))
    add(T_IMAGE_WIDTH, TYPE_LONG, 1, struct.pack("<I", W))
    add(T_IMAGE_LENGTH, TYPE_LONG, 1, struct.pack("<I", H))
    add(T_BITS_PER_SAMPLE, TYPE_SHORT, 1, struct.pack("<HH", 16, 0))
    add(T_COMPRESSION, TYPE_SHORT, 1, struct.pack("<HH", 1, 0))
    add(T_PHOTOMETRIC, TYPE_SHORT, 1, struct.pack("<HH", 32803, 0))  # CFA
    add(T_MAKE, TYPE_ASCII, len(make), make)
    add(T_MODEL, TYPE_ASCII, len(model), model)
    add(T_STRIP_OFFSETS, TYPE_LONG, 1, b"STRIPOFF")  # patched later
    add(T_ORIENTATION, TYPE_SHORT, 1, struct.pack("<HH", 1, 0))
    add(T_SAMPLES_PER_PIXEL, TYPE_SHORT, 1, struct.pack("<HH", 1, 0))
    add(T_ROWS_PER_STRIP, TYPE_LONG, 1, struct.pack("<I", H))
    add(T_STRIP_BYTE_COUNTS, TYPE_LONG, 1, struct.pack("<I", H * W * 2))
    add(T_PLANAR_CONFIG, TYPE_SHORT, 1, struct.pack("<HH", 1, 0))
    add(T_SOFTWARE, TYPE_ASCII, len(b"surround360_tpu\0"), b"surround360_tpu\0")
    add(T_CFA_REPEAT_PATTERN_DIM, TYPE_SHORT, 2, struct.pack("<HH", 2, 2))
    add(T_CFA_PATTERN, TYPE_BYTE, 4, cfa)
    add(T_DNG_VERSION, TYPE_BYTE, 4, bytes([1, 4, 0, 0]))
    add(T_DNG_BACKWARD_VERSION, TYPE_BYTE, 4, bytes([1, 1, 0, 0]))
    add(T_UNIQUE_CAMERA_MODEL, TYPE_ASCII, len(model), model)
    add(T_CFA_PLANE_COLOR, TYPE_BYTE, 3, bytes([0, 1, 2]) + b"\0")
    add(T_CFA_LAYOUT, TYPE_SHORT, 1, struct.pack("<HH", 1, 0))
    add(T_BLACK_LEVEL, TYPE_LONG, 1, struct.pack("<I", black_level))
    add(T_WHITE_LEVEL, TYPE_LONG, 1, struct.pack("<I", white_level))
    add(T_COLOR_MATRIX_1, TYPE_SRATIONAL, 9, cm)
    add(T_AS_SHOT_NEUTRAL, TYPE_SRATIONAL, 3, neutral)
    add(T_CALIBRATION_ILLUMINANT_1, TYPE_SHORT, 1, struct.pack("<HH", 23, 0))

    entries.sort(key=lambda e: e[0])

    header = struct.pack("<2sHI", b"II", 42, 8)
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    data_offset = 8 + ifd_size

    # lay out out-of-line data
    blob_bytes = b""
    for e in entries:
        if e[3] == b"STRIPOFF" or len(e[3]) <= 4:
            e.append(None)
        else:
            e.append(data_offset + len(blob_bytes))  # out-of-line offset
            blob_bytes += e[3]
    # strip offset = after all blob data
    strip_offset = data_offset + len(blob_bytes)

    ifd = struct.pack("<H", n)
    for e in entries:
        tag, typ, count, data = e[0], e[1], e[2], e[3]
        if data == b"STRIPOFF":
            value = struct.pack("<I", strip_offset)
        elif e[4] is not None:
            value = struct.pack("<I", e[4])
        else:
            value = data[:4].ljust(4, b"\0")
        ifd += struct.pack("<HHI", tag, typ, count) + value
    ifd += struct.pack("<I", 0)  # next IFD

    with open(path, "wb") as f:
        f.write(header + ifd + blob_bytes + raw16.tobytes())
