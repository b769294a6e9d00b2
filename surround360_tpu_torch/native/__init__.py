"""Native (C++) footage IO and raw conversion, bound via ctypes.

Port of ``surround360_tpu/native/__init__.py``. ``footage_io.cpp`` is
compiled with g++ at first use into ``surround360_tpu_torch/_build/``
(keyed by the source's hash) and loaded with ctypes; importing this module
builds nothing. :func:`available` says whether the library could be built
and loaded (False without g++ or when the build fails), and callers with a
numpy path of their own (``isp/raw.py``) ask it first. Every other entry
point needs the library: where it is missing it raises ``RuntimeError``
with the compiler's message, it does not return None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

__all__ = [
    "available",
    "convert8_native",
    "convert12_native",
    "pack12_native",
    "NativeFootageWriter",
    "NativeRing",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "footage_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lib = None
_error: str | None = None  # why the library is missing, once tried


def _build() -> str:
    """g++ ``footage_io.cpp`` into ``_build/`` (once per source hash);
    returns the shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libfootage_io_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: native/footage_io.cpp is built at first use")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ footage_io.cpp failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so_path)
    return so_path


def _load():
    """The loaded library; raises ``RuntimeError`` (with the compiler's
    message, remembered after the first try) where it cannot be had."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        lib = ctypes.CDLL(_build())
    except (RuntimeError, OSError) as e:
        _error = f"native footage library unavailable: {e}"
        raise RuntimeError(_error) from e
    vp, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    lib.s360_convert8.argtypes = [vp, vp, i64]
    lib.s360_convert8.restype = None
    lib.s360_convert12.argtypes = [vp, vp, i64, i64]
    lib.s360_convert12.restype = None
    lib.s360_pack12.argtypes = [vp, vp, i64, i64]
    lib.s360_pack12.restype = None
    lib.s360_footage_writer_open.restype = vp
    lib.s360_footage_writer_open.argtypes = [ctypes.c_char_p] + [u32] * 6 + [vp, u32]
    lib.s360_footage_writer_write.restype = ctypes.c_int
    lib.s360_footage_writer_write.argtypes = [vp, u32, vp]
    lib.s360_footage_writer_close.restype = ctypes.c_int
    lib.s360_footage_writer_close.argtypes = [vp]
    lib.s360_ring_create.restype = vp
    lib.s360_ring_create.argtypes = [i64, i64]
    lib.s360_ring_push.restype = ctypes.c_int
    lib.s360_ring_push.argtypes = [vp, vp, i64]
    lib.s360_ring_pop.restype = i64
    lib.s360_ring_pop.argtypes = [vp, vp]
    lib.s360_ring_done.restype = None
    lib.s360_ring_done.argtypes = [vp]
    lib.s360_ring_destroy.restype = None
    lib.s360_ring_destroy.argtypes = [vp]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library is there (building it on first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _frame_bytes(buf, count: int) -> np.ndarray:
    src = np.frombuffer(buf, dtype=np.uint8)
    if src.size < count:
        raise ValueError(f"frame buffer of {src.size} bytes, need {count}")
    return np.ascontiguousarray(src[:count])


def convert12_native(buf, width: int, height: int) -> np.ndarray:
    """12-bit packed frame -> (height, width) uint16, as
    ``isp.raw.convert_12bit_frame``."""
    lib = _load()
    if width % 2:
        raise ValueError(f"12-bit frames need an even width, got {width}")
    src = _frame_bytes(buf, width * height * 3 // 2)
    out = np.empty((height, width), dtype=np.uint16)
    lib.s360_convert12(src.ctypes.data, out.ctypes.data, width, height)
    return out


def convert8_native(buf, width: int, height: int) -> np.ndarray:
    """8-bit frame -> (height, width) uint16 by bit replication."""
    lib = _load()
    src = _frame_bytes(buf, width * height)
    out = np.empty((height, width), dtype=np.uint16)
    lib.s360_convert8(src.ctypes.data, out.ctypes.data, width * height)
    return out


def pack12_native(values: np.ndarray) -> bytes:
    """(H, W) 12-bit values -> packed bytes, as ``isp.raw.pack_12bit_frame``."""
    lib = _load()
    v = np.ascontiguousarray(values, dtype=np.uint16)
    h, w = v.shape
    if w % 2:
        raise ValueError(f"12-bit packing needs an even width, got {w}")
    out = np.empty(h * w * 3 // 2, dtype=np.uint8)
    lib.s360_pack12(v.ctypes.data, out.ctypes.data, w, h)
    return out.tobytes()


class NativeFootageWriter:
    """Streaming .bin writer backed by the C++ implementation; the file's
    bytes equal ``isp.footage.write_footage_file``'s. Frames are written
    in file order (frame major, then camera); close it, or use it as a
    context manager."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        bits_per_pixel: int,
        serials,
        timestamp: int = 0,
        file_index: int = 0,
        file_count: int = 1,
    ):
        self._lib = _load()
        s = np.ascontiguousarray(np.asarray(serials, dtype=np.uint32))
        self._handle = self._lib.s360_footage_writer_open(
            path.encode(), timestamp, file_index, file_count,
            width, height, bits_per_pixel, s.ctypes.data, len(s),
        )
        if not self._handle:
            raise OSError(f"could not open footage file: {path}")
        self.frame_size = width * height * bits_per_pixel // 8

    def write_frame(self, camera: int, payload: bytes) -> None:
        if len(payload) != self.frame_size:
            raise ValueError(
                f"payload of {len(payload)} bytes, frame size {self.frame_size}"
            )
        buf = np.ascontiguousarray(np.frombuffer(payload, dtype=np.uint8))
        if self._lib.s360_footage_writer_write(self._handle, camera, buf.ctypes.data):
            raise OSError("footage write failed")

    def close(self) -> None:
        if self._handle:
            handle, self._handle = self._handle, None
            if self._lib.s360_footage_writer_close(handle):
                raise OSError("closing the footage file failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRing:
    """Bounded single-producer / single-consumer ring of byte payloads
    (the capture daemon's producer / consumer decoupling). ``push`` blocks
    while every slot is full and ``pop`` while none is; both return at once
    after ``done``: pushes then fail, pops drain what is left and then
    return None. The calls release the GIL (ctypes), so a producer and a
    consumer thread run side by side."""

    def __init__(self, slot_size: int, n_slots: int):
        self._lib = _load()
        self._handle = self._lib.s360_ring_create(slot_size, n_slots)
        if not self._handle:
            raise ValueError(f"bad ring shape: {n_slots} slots of {slot_size} bytes")
        self.slot_size = slot_size

    def push(self, data) -> bool:
        """Copy ``data`` into the next free slot; False once the ring is
        done. A payload larger than a slot raises ``ValueError``."""
        buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
        if buf.size > self.slot_size:
            raise ValueError(
                f"payload of {buf.size} bytes, ring slots of {self.slot_size}"
            )
        rc = self._lib.s360_ring_push(self._handle, buf.ctypes.data, buf.size)
        if rc == -2:
            raise ValueError(f"payload of {buf.size} bytes refused by the ring")
        return rc == 0

    def pop(self) -> bytes | None:
        """The oldest payload, or None once the ring is done and drained."""
        out = np.empty(self.slot_size, dtype=np.uint8)
        n = self._lib.s360_ring_pop(self._handle, out.ctypes.data)
        return None if n < 0 else out[:n].tobytes()

    def done(self) -> None:
        self._lib.s360_ring_done(self._handle)

    def destroy(self) -> None:
        if self._handle:
            handle, self._handle = self._handle, None
            self._lib.s360_ring_destroy(handle)
