"""Raw frame conversion: packed sensor formats -> normalized float planes.

Port of ``surround360_tpu/isp/raw.py`` (reference:
surround360_render/source/camera_isp/RawConverter.cpp) as vectorized numpy
on the host (the per-pixel C++ loops become strided slices), or the native
C++ library where it built (``native.available()``). ``pack_12bit_frame``
is the inverse, used by the capture simulator to fabricate footage files.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = [
    "convert_8bit_numpy",
    "convert_12bit_numpy",
    "convert_8bit_frame",
    "convert_12bit_frame",
    "convert_16bit_frame",
    "pack_12bit_frame",
]


def convert_8bit_numpy(buf, width: int, height: int) -> np.ndarray:
    """:func:`convert_8bit_frame` in numpy."""
    frame = np.frombuffer(buf, dtype=np.uint8, count=width * height)
    return (frame.astype(np.uint16) * 0x101).reshape(height, width)


def convert_8bit_frame(buf, width: int, height: int) -> np.ndarray:
    """8-bit raw -> uint16 via bit replication v * 0x101
    (RawConverter.cpp:15-32). Uses the native C++ path when built."""
    if native.available():
        return native.convert8_native(buf, width, height)
    return convert_8bit_numpy(buf, width, height)


def convert_12bit_numpy(buf, width: int, height: int) -> np.ndarray:
    """:func:`convert_12bit_frame` in numpy."""
    n_bytes = width * height * 3 // 2
    frame = np.frombuffer(buf, dtype=np.uint8, count=n_bytes).reshape(
        height, width * 3 // 2
    ).astype(np.uint16)
    b0 = frame[:, 0::3]
    b1 = frame[:, 1::3]
    b2 = frame[:, 2::3]
    even = (b0 << 4) | (b1 & 0xF)
    odd = (b2 << 4) | (b1 >> 4)
    un = np.empty((height, width), dtype=np.uint16)
    un[:, 0::2] = even
    un[:, 1::2] = odd
    return (un << 4) | (un >> 8)


def convert_12bit_frame(buf, width: int, height: int) -> np.ndarray:
    """12-bit packed (two pixels per 3 bytes, odd/even swizzle) -> uint16
    with 4-bit replication (RawConverter.cpp:34-58).

    even x at byte offset p:   unswizzled = lo << 4 | (hi & 0xF)
    odd  x at byte offset p+1: unswizzled = hi << 4 | lo >> 4
    output = unswizzled << 4 | unswizzled >> 8

    Uses the native C++ path when built.
    """
    if native.available():
        return native.convert12_native(buf, width, height)
    return convert_12bit_numpy(buf, width, height)


def convert_16bit_frame(buf, width: int, height: int) -> np.ndarray:
    frame = np.frombuffer(buf, dtype="<u2", count=width * height)
    return frame.reshape(height, width).copy()


def pack_12bit_frame(values12: np.ndarray) -> bytes:
    """Inverse of convert_12bit_frame: (H, W) uint16 12-bit values ->
    packed bytes (capture simulator / footage writer)."""
    h, w = values12.shape
    if w % 2:
        raise ValueError(f"12-bit packing needs an even width, got {w}")
    v = values12.astype(np.uint16) & 0xFFF
    even = v[:, 0::2]
    odd = v[:, 1::2]
    out = np.empty((h, w * 3 // 2), dtype=np.uint8)
    out[:, 0::3] = (even >> 4).astype(np.uint8)
    out[:, 1::3] = (((odd & 0xF) << 4) | (even & 0xF)).astype(np.uint8)
    out[:, 2::3] = (odd >> 4).astype(np.uint8)
    return out.tobytes()
