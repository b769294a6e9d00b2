"""The port's native ring and capture daemon against the JAX package.

The reference's ring cases (tests/test_native.py) run on the port's
``NativeRing``; the daemon's .bin files are held byte for byte to the JAX
package's pure-Python ``isp.footage.write_footage_file`` (which needs no
native library, so the comparison cannot skip when the reference's own
build is missing). Every thread the tests start, and every ``record``,
runs under a join timeout: a hang fails the test instead of stalling the
suite.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest

from surround360_tpu.isp.footage import write_footage_file as jax_write_footage
from surround360_tpu.isp.raw import pack_12bit_frame as jax_pack12
from surround360_tpu_torch import native
from surround360_tpu_torch.capture import daemon as D
from surround360_tpu_torch.isp import BinaryFootageReader

TIMEOUT = 60.0  # seconds; each case takes well under one

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def _in_thread(fn, *args):
    """Run ``fn`` in a thread joined with a timeout; returns its result or
    raises its exception. Fails if the thread is still alive."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), f"{fn} did not return within {TIMEOUT} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_ring_fifo_order_and_shutdown():
    ring = native.NativeRing(slot_size=64, n_slots=4)
    try:
        for i in range(4):
            assert ring.push(bytes([i]) * 10)
        for i in range(4):
            assert ring.pop() == bytes([i]) * 10
        ring.done()
        assert ring.pop() is None
        assert not ring.push(b"late")
    finally:
        ring.destroy()


def test_ring_threaded_producer_consumer():
    ring = native.NativeRing(slot_size=1024, n_slots=4)
    received = []

    def consumer():
        while (item := ring.pop()) is not None:
            received.append(item)

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    sent = [bytes([i % 256]) * 100 for i in range(50)]
    try:
        for s in sent:
            assert _in_thread(ring.push, s)  # blocks while full; the consumer drains
        ring.done()
        t.join(TIMEOUT)
        assert not t.is_alive()
    finally:
        ring.done()
        t.join(TIMEOUT)
        ring.destroy()
    assert received == sent


def test_ring_refuses_oversize_payload():
    """The reference copies a payload of any size into its slot; the port
    refuses one larger than the slot, in Python and in the C++ call."""
    ring = native.NativeRing(slot_size=16, n_slots=2)
    try:
        with pytest.raises(ValueError, match="ring slots of 16"):
            ring.push(bytes(17))
        buf = np.zeros(17, np.uint8)
        assert ring._lib.s360_ring_push(ring._handle, buf.ctypes.data, 17) == -2
        assert ring.push(bytes(16)) and ring.pop() == bytes(16)
    finally:
        ring.destroy()
    with pytest.raises(ValueError, match="bad ring shape"):
        native.NativeRing(slot_size=0, n_slots=2)


def _payloads(bpp, w, h, frames, cams, seed):
    rng = np.random.default_rng(seed)
    if bpp == 12:
        return {(f, c): jax_pack12(rng.integers(0, 4096, (h, w), dtype=np.uint16))
                for f in range(frames) for c in range(cams)}
    return {(f, c): rng.integers(0, 256, w * h, dtype=np.uint8).tobytes()
            for f in range(frames) for c in range(cams)}


@pytest.mark.parametrize("bpp", [8, 12])
def test_daemon_files_equal_jax_writer(tmp_path, bpp):
    """Each consumer's .bin equals write_footage_file of its cameras
    (round-robin), serials, file_index and file_count."""
    W, H, frames, serials = 24, 10, 3, [300, 100, 500, 200, 400]
    payloads = _payloads(bpp, W, H, frames, len(serials), bpp)
    paths = [str(tmp_path / f"{i}.bin") for i in range(2)]
    daemon = D.CaptureDaemon(paths, W, H, bpp, serials, ring_slots=2)
    stats = _in_thread(daemon.record, lambda f, c: (payloads[(f, c)], f), frames)
    assert stats.frames_produced == stats.frames_written == frames * len(serials)
    assert stats.frames_dropped == 0
    assert stats.per_camera_written == {c: frames for c in range(len(serials))}
    for cid, path in enumerate(paths):
        cams = [c for c in range(len(serials)) if c % 2 == cid]
        want = str(tmp_path / f"want{cid}.bin")
        jax_write_footage(want, [[payloads[(f, c)] for c in cams] for f in range(frames)],
                          W, H, bpp, [serials[c] for c in cams], file_index=cid,
                          file_count=2)
        assert open(path, "rb").read() == open(want, "rb").read()
        reader = BinaryFootageReader(path)
        assert reader.num_frames == frames and reader.num_cameras == len(cams)


def test_daemon_counts_drops_as_the_reference(tmp_path):
    """tests/test_native.py's case: camera 1 skips counter 2; the drop is
    counted and every frame is still written."""
    W = H = 16
    serials = [100, 200, 300]
    payloads = _payloads(12, W, H, 4, 3, 3)

    def source(frame, cam):
        counter = frame if not (cam == 1 and frame >= 2) else frame + 1
        return payloads[(frame, cam)], counter

    paths = [str(tmp_path / "0.bin"), str(tmp_path / "1.bin")]
    stats = _in_thread(D.CaptureDaemon(paths, W, H, 12, serials).record, source, 4)
    assert stats.frames_produced == 12
    assert stats.frames_written == 12
    assert stats.frames_dropped == 1
    r0, r1 = BinaryFootageReader(paths[0]), BinaryFootageReader(paths[1])
    assert r0.num_cameras == 2 and r0.num_frames == 4
    assert r1.num_cameras == 1 and r1.num_frames == 4
    assert r0.get_serial(0, 0) == 100
    assert r0.get_serial(0, 1) == 300
    assert r1.get_serial(3, 0) == 200


def test_failed_consumer_makes_record_raise(tmp_path, monkeypatch):
    """A write that fails in one consumer ends its ring: the producer stops
    at its next push (the reference blocks there forever once the ring is
    full), every thread is joined, the files are closed and record raises
    the consumer's error."""
    W = H = 8
    serials = [1, 2, 3, 4]
    real_write = native.NativeFootageWriter.write_frame
    calls = []

    def failing_write(self, camera, payload):
        calls.append(camera)
        if len(calls) == 3:
            raise OSError("disk full")
        real_write(self, camera, payload)

    monkeypatch.setattr(native.NativeFootageWriter, "write_frame", failing_write)
    before = threading.active_count()
    paths = [str(tmp_path / f"{i}.bin") for i in range(2)]
    daemon = D.CaptureDaemon(paths, W, H, 8, serials, ring_slots=1)
    payload = bytes(W * H)
    with pytest.raises(OSError, match="disk full"):
        _in_thread(daemon.record, lambda f, c: (payload, f), 200)
    assert daemon.stats.frames_produced < 200 * len(serials)
    assert threading.active_count() == before
    for path in paths:  # closed: the header and whole frames are on disk
        assert (tmp_path / path).stat().st_size >= 4096


def test_failed_source_makes_record_raise(tmp_path):
    """A frame source that raises: the consumers drain and end, and the
    source's error propagates."""
    def source(frame, cam):
        if frame == 2:
            raise RuntimeError("camera lost")
        return bytes(64), frame

    before = threading.active_count()
    daemon = D.CaptureDaemon([str(tmp_path / "0.bin")], 8, 8, 8, [7, 8])
    with pytest.raises(RuntimeError, match="camera lost"):
        _in_thread(daemon.record, source, 5)
    assert threading.active_count() == before
    assert daemon.stats.frames_written == daemon.stats.frames_produced == 4
    assert BinaryFootageReader(str(tmp_path / "0.bin")).num_frames == 2


def test_daemon_counters_hold_under_thread_switching(tmp_path):
    """More consumers than cores and a tiny switch interval: the counters
    the consumers share add up (a lost update would break the sums)."""
    n_consumers = max(2 * (os.cpu_count() or 1), 8)
    serials = list(range(2 * n_consumers))
    payload = bytes(64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        daemon = D.CaptureDaemon([str(tmp_path / f"{i}.bin") for i in range(n_consumers)],
                                 8, 8, 8, serials, ring_slots=2)
        stats = _in_thread(daemon.record, lambda f, c: (payload, f), 50)
    finally:
        sys.setswitchinterval(old)
    n = 50 * len(serials)
    assert stats.frames_produced == stats.frames_written == n
    assert stats.per_camera_written == {c: 50 for c in serials}
