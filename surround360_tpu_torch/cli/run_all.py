"""The whole pipeline in one command: unpack -> render -> encode.

Port of ``surround360_tpu/cli/run_all.py`` (reference: scripts/run_all.py):
three steps with per-step timing written to runtimes.txt
(run_all.py:132-155); ffmpeg stays an external subprocess
(run_all.py:74-88, CRF 10 final / CRF 20 ultrafast preview):

    python -m surround360_tpu_torch.cli.run_all --binary_prefix bins \\
        --isp_dir isp --rig_json_file rig.json --dest_dir out --quality 6k \\
        --enable_top --enable_bottom [--steps unpack,render] [--device cuda]

The ISP of the unpack step and the renderer run on ``--device`` (``cuda``,
the default, raises when there is no GPU; ``cpu`` runs on the CPU). The
render step builds its ``RenderConfig`` as the reference's ``run_all`` does.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

from .common import log, resolve_device, setup_logging
from .render_video import (
    PRESET_SHARPENING,
    QUALITY_PRESETS,
    RenderConfig,
    render_video,
)
from .unpack import unpack

FFMPEG_FINAL = (
    "ffmpeg -framerate 30 -start_number {start} -i {frames} -pix_fmt yuv420p "
    "-c:v libx264 -crf 10 -profile:v high -tune fastdecode -bf 0 -refs 3 "
    "-preset fast {output} -y"
)
FFMPEG_PREVIEW = (
    "ffmpeg -framerate 30 -start_number {start} -i {frames} -pix_fmt yuv420p "
    "-c:v libx264 -crf 20 -preset ultrafast {output} -y"
)


def run_all(args) -> None:
    resolve_device(args.device)  # before any step writes
    runtimes = []
    steps = args.steps.split(",")

    if "unpack" in steps:
        t0 = time.time()
        bins = [
            os.path.join(args.binary_prefix, f"{i}.bin")
            for i in range(args.file_count)
        ]
        unpack(
            bins,
            os.path.join(args.dest_dir, "raw"),
            args.isp_dir,
            args.start_frame,
            args.frame_count,
            device=args.device,
        )
        runtimes.append(("unpack", time.time() - t0))

    if "render" in steps:
        t0 = time.time()
        eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[args.quality]
        cfg = RenderConfig(
            eqr_width=eqr_w,
            eqr_height=eqr_h,
            final_eqr_width=fin_w,
            final_eqr_height=fin_h,
            sharpening=args.sharpening,
            enable_top=args.enable_top,
            enable_bottom=args.enable_bottom,
            enable_pole_removal=args.enable_pole_removal,
            side_flow_alg=args.flow_alg,
            polar_flow_alg=args.flow_alg,
            poleremoval_flow_alg=args.flow_alg,
        )
        end_frame = (
            args.start_frame + args.frame_count - 1
            if args.frame_count
            else args.start_frame
        )
        render_video(
            args.rig_json_file,
            os.path.join(args.dest_dir, "raw"),
            args.dest_dir,
            args.start_frame,
            end_frame,
            cfg,
            pole_masks_dir=args.pole_masks_dir,
            save_state_dir=os.path.join(args.dest_dir, "flow_state"),
            device=args.device,
        )
        runtimes.append(("render", time.time() - t0))

    if "ffmpeg" in steps:
        t0 = time.time()
        if shutil.which("ffmpeg") is None:
            log.warning("ffmpeg not found on PATH; skipping encode step")
        else:
            template = FFMPEG_PREVIEW if args.quality == "preview" else FFMPEG_FINAL
            cmd = template.format(
                start=args.start_frame,
                frames=os.path.join(
                    args.dest_dir, "eqr_frames", "eqr_%06d.png"
                ),
                output=os.path.join(args.dest_dir, "video.mp4"),
            )
            log.info("running: %s", cmd)
            subprocess.run(cmd.split(), check=True)
        runtimes.append(("ffmpeg", time.time() - t0))

    with open(os.path.join(args.dest_dir, "runtimes.txt"), "w") as f:
        for name, dt in runtimes:
            f.write(f"{name}: {dt:.1f} sec\n")
    log.info("done; runtimes: %s", runtimes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", default="unpack,render,ffmpeg")
    p.add_argument("--binary_prefix", default="")
    p.add_argument("--file_count", type=int, default=1)
    p.add_argument("--dest_dir", required=True)
    p.add_argument("--isp_dir", default="")
    p.add_argument("--rig_json_file", required=False, default="")
    p.add_argument("--quality", default="preview", choices=QUALITY_PRESETS)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--frame_count", type=int, default=1)
    p.add_argument("--sharpening", type=float, default=PRESET_SHARPENING)
    p.add_argument("--enable_top", action="store_true")
    p.add_argument("--enable_bottom", action="store_true")
    p.add_argument("--enable_pole_removal", action="store_true")
    p.add_argument("--pole_masks_dir", default=None)
    p.add_argument("--flow_alg", default="pixflow_tpu")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    resolve_device(args.device)
    os.makedirs(args.dest_dir, exist_ok=True)
    run_all(args)


if __name__ == "__main__":
    main()
