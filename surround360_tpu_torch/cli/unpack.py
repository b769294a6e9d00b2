"""Unpack: capture .bin files -> per-camera RGB image trees.

Port of ``surround360_tpu/cli/unpack.py`` (reference: the Unpacker binary,
surround360_render/source/camera_isp/Unpacker.cpp): for each camera in
each footage file, decode raw frames, run the ISP with that serial's JSON,
and write <out>/camN/NNNNNN.png, with camera dirs named cam0..N sorted by
serial (Unpacker.cpp:208-221):

    python -m surround360_tpu_torch.cli.unpack --binary_prefix bins \\
        --dest_path raw --isp_dir isp [--output_bpp 16] [--device cuda]

The reference's std::async camera fan-out (Unpacker.cpp:117-194) is a
frame-batched ISP call (one per chunk of :data:`ISP_BATCH` frames of a
camera) on ``--device`` (``cuda``, the default, raises when there is no
GPU; ``cpu`` runs the ISP on the CPU), with the PNG writes overlapped on a
host thread pool.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..isp import BinaryFootageReader, isp_process, load_isp_config
from .common import StageTimer, log, resolve_device, setup_logging, write_image

# frames of one camera per ISP call
ISP_BATCH = 8


def unpack(
    bin_paths: list[str],
    output_dir: str,
    isp_dir: str,
    start_frame: int = 0,
    frame_count: int = 0,
    output_bpp: int = 8,
    device: str = "cuda",
    timer: StageTimer | None = None,
) -> list[str]:
    """Returns the list of camera directory names written (serial order).

    ``timer`` (a fresh one when None) receives, per chunk of frames, the
    host stages ``read`` (the .bin decode to uint16) and ``isp`` (upload,
    the ISP and the fetch, synchronized), per frame ``write`` (the PNG, on
    the pool's threads), then ``drain`` (waiting for the pool)."""
    timer = StageTimer() if timer is None else timer
    device = resolve_device(device)
    readers = [BinaryFootageReader(p) for p in bin_paths]

    # discover serials: (reader, camera_index) -> serial
    entries = []
    for r in readers:
        for cam in range(r.num_cameras):
            entries.append((r, cam, r.get_serial(0, cam)))
    serial_sorted = sorted(entries, key=lambda e: e[2])
    cam_names = {
        serial: f"cam{i}" for i, (_, _, serial) in enumerate(serial_sorted)
    }
    log.info("serials: %s", cam_names)

    def write(path, rgb):
        with timer.stage("write"):
            write_image(path, rgb, bit_depth=output_bpp)

    with ThreadPoolExecutor(max_workers=8) as pool:
        futures = []
        for reader, cam, serial in serial_sorted:
            cam_dir = os.path.join(output_dir, cam_names[serial])
            os.makedirs(cam_dir, exist_ok=True)
            cfg = load_isp_config(os.path.join(isp_dir, f"{serial}.json"))
            n_frames = reader.num_frames if frame_count == 0 else min(
                reader.num_frames, start_frame + frame_count
            )
            frames = list(range(start_frame, n_frames))
            for c0 in range(0, len(frames), ISP_BATCH):
                chunk = frames[c0 : c0 + ISP_BATCH]
                with timer.stage("read"):
                    raws = np.stack(
                        [reader.get_raw_uint16(f, cam) for f in chunk]
                    ).astype(np.float32) / 65535.0
                with timer.stage("isp"):
                    rgbs = isp_process(torch.from_numpy(raws).to(device), cfg)
                    rgbs = rgbs.cpu().numpy()
                for f, rgb in zip(chunk, rgbs):
                    futures.append(pool.submit(
                        write, os.path.join(cam_dir, f"{f:06d}.png"), rgb
                    ))
            log.info("unpacked %s (%d frames)", cam_names[serial], len(frames))
        with timer.stage("drain"):
            for fut in futures:
                fut.result()
    return [cam_names[s] for (_, _, s) in serial_sorted]


def main(argv=None, timer: StageTimer | None = None):
    """The command line; ``timer`` as in :func:`unpack`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--binary_prefix", required=True,
                   help="directory containing N.bin capture files")
    p.add_argument("--file_count", type=int, default=1)
    p.add_argument("--dest_path", required=True)
    p.add_argument("--isp_dir", required=True)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--frame_count", type=int, default=0)
    p.add_argument("--output_bpp", type=int, default=8, choices=[8, 16])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    bins = [
        os.path.join(args.binary_prefix, f"{i}.bin")
        for i in range(args.file_count)
    ]
    return unpack(
        bins,
        args.dest_path,
        args.isp_dir,
        args.start_frame,
        args.frame_count,
        args.output_bpp,
        device=args.device,
        timer=timer,
    )


if __name__ == "__main__":
    main()
