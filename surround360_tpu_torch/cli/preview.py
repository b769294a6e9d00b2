"""Preview CLI: .bin footage -> fast preview frames (+ optional video).

Port of ``surround360_tpu/cli/preview.py`` (reference: scripts/preview.py
driving TestHyperPreview): the three fisheye cameras of each frame through
``render.preview.PreviewRenderer`` on ``--device`` (``cuda`` unless
``--device cpu``), each frame written as ``%06d.jpg`` by the package's
own JPEG codec."""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

from ..geometry.rig import load_rig
from ..isp import BinaryFootageReader
from ..render.preview import PreviewRenderer
from .common import StageTimer, log, resolve_device, setup_logging, write_image


def fisheye_raws(readers, rig, frame: int) -> list[np.ndarray]:
    """The top, bottom and second bottom cameras' raws of ``frame`` as
    (H, W) float32 in [0,1]. Cameras are found by serial order across the
    files: capture writes the serials in the rig's camera order."""
    entries = sorted(((r, cam, r.get_serial(0, cam)) for r in readers
                      for cam in range(r.num_cameras)), key=lambda e: e[2])
    return [entries[i][0].get_raw_uint16(frame, entries[i][1]).astype(np.float32) / 65535.0
            for i in (rig.top_camera_index, rig.bottom_camera_index,
                      rig.bottom_camera2_index)]


def main(argv=None, timer: StageTimer | None = None):
    """Run the preview; returns the frames written. ``timer`` (optional)
    collects the loop's stages: read, render (on the device, synchronised)
    and encode."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--binary_prefix", required=True)
    p.add_argument("--file_count", type=int, default=1)
    p.add_argument("--rig_json_file", required=True)
    p.add_argument("--preview_dest", required=True)
    p.add_argument("--eqr_width", type=int, default=1024)
    p.add_argument("--eqr_height", type=int, default=512)
    p.add_argument("--softmax_coef", type=float, default=5.0)
    p.add_argument("--gamma", type=float, default=0.4545)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--frame_count", type=int, default=0)
    p.add_argument("--make_video", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    timer = timer or StageTimer()

    rig = load_rig(args.rig_json_file)
    readers = [
        BinaryFootageReader(os.path.join(args.binary_prefix, f"{i}.bin"))
        for i in range(args.file_count)
    ]

    # the renderer's cameras rescaled to the capture resolution
    md = readers[0].metadata
    native = float(np.asarray(rig.cameras[0].resolution)[0])
    pr = PreviewRenderer(
        rig.rescaled(md.width / native),
        eqr_width=args.eqr_width,
        eqr_height=args.eqr_height,
        softmax_coef=args.softmax_coef,
        gamma=args.gamma,
        device=device,
    )

    n_frames = readers[0].num_frames
    end = n_frames if args.frame_count == 0 else min(
        n_frames, args.start_frame + args.frame_count
    )
    os.makedirs(args.preview_dest, exist_ok=True)

    written = []
    for frame in range(args.start_frame, end):
        with timer.stage("read"):
            raws = fisheye_raws(readers, rig, frame)
        with timer.stage("render"):
            out = pr.render(*raws).cpu().numpy()
        path = os.path.join(args.preview_dest, f"{frame:06d}.jpg")
        with timer.stage("encode"):
            write_image(path, out)
        log.info("preview frame %06d -> %s", frame, path)
        written.append(path)

    if args.make_video:
        if shutil.which("ffmpeg") is None:
            log.warning("ffmpeg not found; skipping video encode")
        else:
            cmd = (
                f"ffmpeg -framerate 30 -start_number {args.start_frame} "
                f"-i {args.preview_dest}/%06d.jpg -pix_fmt yuv420p "
                f"-c:v libx264 -crf 20 -preset ultrafast "
                f"{args.preview_dest}/preview.mp4 -y"
            )
            subprocess.run(cmd.split(), check=True)
    return written


if __name__ == "__main__":
    main()
