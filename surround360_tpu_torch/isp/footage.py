"""Binary footage (.bin) capture-file format: reader + writer.

Port of ``surround360_tpu/isp/footage.py`` (reference:
surround360_render/source/camera_isp/BinaryFootageFile.{h,cpp}, the mmap
reader, and the writer side of the capture app's consumer threads
(surround360_camera_ctl_ui/source/CameraController.cpp:393-467)); bytes
written equal the reference package's:

- 4096-byte header whose first 32 bytes are the packed MetadataHeader
  {magic=0xfaceb00c, timestamp, fileIndex, fileCount, width, height,
  bitsPerPixel, numberOfCameras} (BinaryFootageFile.h:18-27);
- frames laid out as base + 4096 + (numCams * frame + cam) * frameSize
  (BinaryFootageFile.cpp:179-202);
- each frame's first 8 bytes are stamped with (frameSize, cameraSerial)
  uint32s over the raw data (CameraController.cpp:453-455; the unpacker
  reads the serial from word 1, Unpacker.cpp:125).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = 0xFACEB00C
HEADER_SIZE = 4096
_HEADER_FMT = "<8I"

__all__ = ["BinaryFootageReader", "write_footage_file", "FootageMetadata"]


@dataclass(frozen=True)
class FootageMetadata:
    magic: int
    timestamp: int
    file_index: int
    file_count: int
    width: int
    height: int
    bits_per_pixel: int
    number_of_cameras: int

    @property
    def frame_size(self) -> int:
        return self.width * self.height * self.bits_per_pixel // 8


class BinaryFootageReader:
    """Memory-mapped .bin reader."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        header = struct.unpack(_HEADER_FMT, bytes(self._mm[:32]))
        self.metadata = FootageMetadata(*header)
        if self.metadata.magic != MAGIC:
            raise ValueError(
                f"invalid footage magic 0x{self.metadata.magic:08x} in {path}"
            )

    @property
    def num_cameras(self) -> int:
        return self.metadata.number_of_cameras

    @property
    def num_frames(self) -> int:
        payload = self._mm.size - HEADER_SIZE
        return payload // (self.metadata.frame_size * self.num_cameras)

    def get_frame_bytes(self, frame: int, camera: int) -> np.ndarray:
        fs = self.metadata.frame_size
        off = HEADER_SIZE + (self.num_cameras * frame + camera) * fs
        return self._mm[off : off + fs]

    def get_serial(self, frame: int, camera: int) -> int:
        raw = self.get_frame_bytes(frame, camera)
        return int(np.frombuffer(bytes(raw[:8]), dtype="<u4")[1])

    def get_raw_uint16(self, frame: int, camera: int) -> np.ndarray:
        """Frame decoded to (H, W) uint16 per its bit depth."""
        from .raw import convert_8bit_frame, convert_12bit_frame, convert_16bit_frame

        buf = bytes(self.get_frame_bytes(frame, camera))
        md = self.metadata
        if md.bits_per_pixel == 8:
            return convert_8bit_frame(buf, md.width, md.height)
        if md.bits_per_pixel == 12:
            return convert_12bit_frame(buf, md.width, md.height)
        if md.bits_per_pixel == 16:
            return convert_16bit_frame(buf, md.width, md.height)
        raise ValueError(f"unsupported bitsPerPixel {md.bits_per_pixel}")


def write_footage_file(
    path: str,
    frames: list[list[bytes]],
    width: int,
    height: int,
    bits_per_pixel: int,
    serials: list[int],
    timestamp: int = 0,
    file_index: int = 0,
    file_count: int = 1,
) -> None:
    """Write a .bin: frames[frame][camera] are packed raw payloads. Each
    frame gets (frameSize, serial) stamped over its first 8 bytes like the
    capture app's consumer."""
    frame_size = width * height * bits_per_pixel // 8
    header = struct.pack(
        _HEADER_FMT,
        MAGIC,
        timestamp,
        file_index,
        file_count,
        width,
        height,
        bits_per_pixel,
        len(serials),
    )
    with open(path, "wb") as f:
        f.write(header + b"\0" * (HEADER_SIZE - len(header)))
        for frame in frames:
            if len(frame) != len(serials):
                raise ValueError(f"{len(frame)} payloads for {len(serials)} cameras")
            for cam, payload in enumerate(frame):
                if len(payload) != frame_size:
                    raise ValueError(
                        f"payload of {len(payload)} bytes, frame size {frame_size}"
                    )
                stamped = (
                    struct.pack("<2I", frame_size, serials[cam]) + payload[8:]
                )
                f.write(stamped)
