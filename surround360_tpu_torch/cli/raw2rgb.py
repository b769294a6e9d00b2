"""Single-image ISP tool: raw in, RGB out, optional DNG out.

Port of ``surround360_tpu/cli/raw2rgb.py`` (reference:
surround360_render/source/camera_isp/Raw2Rgb.cpp): loads a raw mosaic (an
8- or 16-bit PNG or TIFF; of a colour file its blue channel, the first one
of the reference's BGR reader), runs the configured ISP on ``--device`` (``cuda``, the default, raises when there is no GPU),
writes the RGB result, and optionally a DNG of the raw with the ISP's CCM
and white balance in its metadata:

    python -m surround360_tpu_torch.cli.raw2rgb --input_image_path raw.png \\
        --output_image_path rgb.png --isp_config_path isp.json [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..isp import isp_process, load_isp_config
from .common import log, read_image, resolve_device, setup_logging, write_image
from .dng_helper import save_isp_dng


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_image_path", required=True)
    p.add_argument("--output_image_path", required=True)
    p.add_argument("--isp_config_path", required=True)
    p.add_argument("--output_dng_path", default="")
    p.add_argument(
        "--demosaic_filter",
        default="",
        choices=["", "bilinear", "frequency", "edge_aware"],
    )
    p.add_argument("--disable_tone_curve", action="store_true")
    p.add_argument("--output_bpp", type=int, default=8, choices=[8, 16])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    device = resolve_device(args.device)

    cfg = load_isp_config(args.isp_config_path)
    if args.demosaic_filter:
        cfg = dataclasses.replace(cfg, demosaic_filter=args.demosaic_filter)
    if args.disable_tone_curve:
        cfg = dataclasses.replace(cfg, disable_tone_curve=True)

    raw = read_image(args.input_image_path)
    raw = raw[..., 2 if raw.shape[-1] >= 3 else 0]
    scale = 255.0 if raw.dtype == np.uint8 else 65535.0
    rawf = raw.astype(np.float32) / scale

    t0 = time.time()
    rgb = isp_process(torch.from_numpy(rawf).to(device), cfg).cpu().numpy()
    log.info("ISP runtime: %.1f ms", (time.time() - t0) * 1000)

    write_image(args.output_image_path, rgb, bit_depth=args.output_bpp)
    log.info("wrote %s", args.output_image_path)

    if args.output_dng_path:
        save_isp_dng(args.output_dng_path, raw, cfg)
        log.info("wrote %s", args.output_dng_path)


if __name__ == "__main__":
    main()
