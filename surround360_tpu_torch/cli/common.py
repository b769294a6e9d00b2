"""Shared CLI helpers: image io, flow serialization, logging, timing.

Port of ``surround360_tpu/cli/common.py`` (reference: glog and the
per-stage getCurrTimeSec bracketing, util/SystemUtil.h:63-65,
TestRenderStereoPanorama.cpp:963-971; the flow .bin layout of
util/CvUtil.cpp:159-199).

Images are PNG, JPEG or TIFF, read and written by the package's own
codecs. PNG, on ``zlib`` and ``struct``: 8 or 16 bits per sample; grey,
RGB or RGBA; every scanline filter on read; no interlace. JPEG (``.jpg``,
``.jpeg``; ``cli/jpeg.py``): baseline, quality 95 and 4:2:0 chroma as
OpenCV writes by default, 8 bits, grey or RGB (alpha is dropped). TIFF
(``.tif``, ``.tiff``; ``cli/tiff.py``): baseline strips or tiles,
uncompressed, LZW, Deflate or PackBits on read, Deflate on write; 8 or 16
bits; grey, RGB or RGBA. Any other file raises ``ValueError``. The arrays
are those of the reference's OpenCV reader and writer after its BGR <->
RGB reordering, so files written by either package read the same in both
(JPEG up to its decoder's rounding).
"""

from __future__ import annotations

import logging
import os
import struct
import zlib

import numpy as np
import torch

from ..utils.math_util import disable_tf32
from ..utils.tracing import StageTimer  # noqa: F401 (the CLIs' stage list)
from .jpeg import read_jpeg, write_jpeg
from .tiff import read_tiff, write_tiff

log = logging.getLogger("surround360_tpu_torch")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def setup_logging(verbose: bool = False):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
    )


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; CUDA must be there when asked
    for (no silent fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available (pass --device cpu to "
            "run on the CPU)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {name}")
    disable_tf32()
    return device


_FORMATS = {".png": "png", ".jpg": "jpeg", ".jpeg": "jpeg", ".tif": "tiff", ".tiff": "tiff"}


def _image_format(path: str) -> str:
    """"png", "jpeg" or "tiff" by the file's extension; anything else
    raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _FORMATS:
        raise ValueError(
            f"unsupported image format {ext or '(no extension)'!r}: only PNG, "
            f"JPEG and TIFF are supported: {path}"
        )
    return _FORMATS[ext]


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, hwc: np.ndarray) -> None:
    """(H, W, C) uint8 or uint16 samples, C in {1, 3, 4} (grey, RGB,
    RGBA) -> PNG, every scanline unfiltered."""
    if hwc.dtype not in (np.uint8, np.uint16) or hwc.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8/uint16, got {hwc.shape} {hwc.dtype}")
    H, W, C = hwc.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, got {C}")
    depth = 8 if hwc.dtype == np.uint8 else 16
    rows = np.ascontiguousarray(hwc, dtype=">u2" if depth == 16 else np.uint8)
    raw = np.zeros((H, 1 + rows[0].nbytes), np.uint8)  # filter byte 0
    raw[:, 1:] = rows.view(np.uint8).reshape(H, -1)
    header = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2) -> (H, stride) bytes."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size < H * (stride + 1):
        raise ValueError("truncated PNG image data")
    raw = raw[: H * (stride + 1)].reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: running sum per byte of a pixel, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        elif kind == 2:  # Up
            row = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            row = np.zeros(stride, np.int32)
            cur, up = line.astype(np.int32), prior.astype(np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                b = up[x : x + bpp]
                if kind == 3:
                    pred = (left + b) // 2
                else:
                    pred = _paeth(left, b, up_left)
                left = (cur[x : x + bpp] + pred) & 0xFF
                row[x : x + bpp] = left
                up_left = b
            row = row.astype(np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prior = row
    return out


def read_png(path: str) -> np.ndarray:
    """PNG -> (H, W, C) uint8 or uint16 samples in file order (grey, RGB,
    or RGBA)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path}")
    W, H, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}): {path}"
        )
    C = _CHANNELS[color]
    bpp = C * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    return rows.reshape(H, W, C)


def read_image(path: str) -> np.ndarray:
    """PNG, JPEG or TIFF -> (H, W, C) uint8 or uint16 samples in file
    order (grey, RGB or RGBA)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    reader = {"png": read_png, "jpeg": read_jpeg, "tiff": read_tiff}[_image_format(path)]
    return reader(path)


def read_image_rgba(path: str) -> np.ndarray:
    """PNG, JPEG or TIFF -> (4, H, W) float32 RGBA in [0,1]; grey is
    copied to R, G, B and a missing alpha is 1."""
    img = read_image(path)
    scale = 255.0 if img.dtype == np.uint8 else 65535.0
    img = img.astype(np.float32) / scale
    if img.shape[-1] == 1:
        img = np.concatenate([img] * 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    return np.moveaxis(img, -1, 0)


def write_image(path: str, img, bit_depth: int = 8) -> None:
    """(1|3|4, H, W) float [0,1] -> PNG or TIFF (Deflate) of 8 or 16 bits
    per sample, or an 8-bit JPEG of quality 95 (grey or RGB; alpha is
    dropped)."""
    fmt = _image_format(path)
    if bit_depth not in (8, 16) or (fmt == "jpeg" and bit_depth != 8):
        raise ValueError(f"bit_depth {bit_depth} is not supported for {fmt.upper()}")
    hwc = np.moveaxis(np.asarray(img), 0, -1)
    scale = 255.0 if bit_depth == 8 else 65535.0
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    data = np.clip(hwc * scale + 0.5, 0, scale).astype(dtype)
    if fmt == "png":
        write_png(path, data)
    elif fmt == "tiff":
        write_tiff(path, data)
    else:
        write_jpeg(path, data[..., :3] if data.shape[-1] == 4 else data)


def save_flow(path: str, flow) -> None:
    """(2, H, W) float32 -> reference flow .bin layout (rows, cols, then
    row-major float32 (x, y) pairs)."""
    flow = np.asarray(flow, dtype=np.float32)
    _, H, W = flow.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<2i", H, W))
        f.write(np.stack([flow[0], flow[1]], axis=-1).tobytes())


def load_flow(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        H, W = struct.unpack("<2i", f.read(8))
        data = np.frombuffer(f.read(H * W * 8), dtype=np.float32)
    interleaved = data.reshape(H, W, 2)
    return np.stack([interleaved[..., 0], interleaved[..., 1]], axis=0)
