"""Capture daemon: producer/consumer recording pipeline.

Port of ``surround360_tpu/capture/daemon.py`` (reference: the capture
recorder of surround360_camera_ctl_ui/source/CameraController.{hpp,cpp}).
A producer pulls frames from a source (hardware in the reference; any
callable here, e.g. the capture simulator), counts drops from gaps in the
frames' embedded counters, and pushes each frame through a native ring
(``native.NativeRing``) to one consumer thread per output file, which
writes it into a .bin through the native writer. Cameras go to consumers
round-robin (``cid = camera % consumers``, CameraController.cpp:325).

Unlike the reference package, a consumer that fails ends its ring, so the
producer stops at its next push instead of blocking on a ring nobody
drains; ``record`` then joins every thread, closes the files, frees the
rings and raises the first error. The counters are updated under a lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..native import NativeFootageWriter, NativeRing

__all__ = ["CaptureDaemon", "CaptureStats"]

_HEADER = 8  # (camera index, pad) uint32s ahead of the payload in a ring slot


@dataclass
class CaptureStats:
    frames_produced: int = 0
    frames_written: int = 0
    frames_dropped: int = 0
    per_camera_written: dict = field(default_factory=dict)


class CaptureDaemon:
    """Records ``num_frames`` frames from ``frame_source`` into .bin files.

    frame_source(frame_idx, camera_idx) -> (payload: bytes,
    frame_counter: int). Frame counters emulate the camera's embedded
    counter; gaps are counted as drops (CameraController.cpp:336-341) and
    the frame is written all the same.
    """

    def __init__(
        self,
        dest_paths: list[str],  # one .bin per consumer
        width: int,
        height: int,
        bits_per_pixel: int,
        serials: list[int],
        ring_slots: int = 8,
    ):
        self.width = width
        self.height = height
        self.bpp = bits_per_pixel
        self.serials = serials
        self.frame_size = width * height * bits_per_pixel // 8
        self.n_consumers = len(dest_paths)
        self.dest_paths = dest_paths
        self.ring_slots = ring_slots
        self.stats = CaptureStats()
        self._lock = threading.Lock()
        self._consumer_cams = {
            cid: [c for c in range(len(serials)) if c % self.n_consumers == cid]
            for cid in range(self.n_consumers)
        }

    def _consume(self, ring, writer, cams, errors):
        local_index = {c: i for i, c in enumerate(cams)}
        try:
            while (packet := ring.pop()) is not None:
                cam = int(np.frombuffer(packet[:_HEADER], dtype="<u4")[0])
                writer.write_frame(local_index[cam], packet[_HEADER:])
                with self._lock:
                    self.stats.frames_written += 1
                    per_cam = self.stats.per_camera_written
                    per_cam[cam] = per_cam.get(cam, 0) + 1
        except Exception as e:  # raised by record() after the join
            with self._lock:
                errors.append(e)
            ring.done()  # the producer's next push returns False

    def _produce(self, frame_source, num_frames, rings):
        last_counter = {}
        header = np.zeros(2, dtype="<u4")
        for frame in range(num_frames):
            for cam in range(len(self.serials)):
                payload, counter = frame_source(frame, cam)
                prev = last_counter.get(cam)
                if prev is not None and counter != prev + 1:
                    with self._lock:
                        self.stats.frames_dropped += counter - prev - 1
                last_counter[cam] = counter
                header[0] = cam
                if not rings[cam % self.n_consumers].push(header.tobytes() + payload):
                    return  # that consumer failed
                with self._lock:
                    self.stats.frames_produced += 1

    def record(self, frame_source, num_frames: int) -> CaptureStats:
        rings, writers, threads, errors = [], [], [], []
        try:
            for cid, path in enumerate(self.dest_paths):
                rings.append(NativeRing(self.frame_size + _HEADER, self.ring_slots))
                writers.append(NativeFootageWriter(
                    path, self.width, self.height, self.bpp,
                    [self.serials[c] for c in self._consumer_cams[cid]],
                    file_index=cid, file_count=self.n_consumers,
                ))
            for cid in range(self.n_consumers):
                t = threading.Thread(
                    target=self._consume, daemon=True,
                    args=(rings[cid], writers[cid], self._consumer_cams[cid], errors),
                )
                t.start()
                threads.append(t)
            self._produce(frame_source, num_frames, rings)
        finally:
            for ring in rings:
                ring.done()
            for t in threads:
                t.join()
            for w in writers:
                try:
                    w.close()
                except OSError as e:
                    errors.append(e)
            for ring in rings:
                ring.destroy()
        if errors:
            raise errors[0]
        return self.stats
