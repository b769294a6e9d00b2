"""Compare rendered frames against expected/golden renders.

Port of ``surround360_tpu/cli/compare.py``: PSNR / RMSE per frame pair of
two directories (PNG, JPEG or TIFF, read by the package's own codecs) and a
summary; ``--min_psnr_db`` makes the exit code fail below a floor.

    python -m surround360_tpu_torch.cli.compare --dir_a out/eqr_frames \
        --dir_b golden/eqr_frames [--report report.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .common import log, read_image_rgba, setup_logging


def compare_images(a: np.ndarray, b: np.ndarray) -> dict:
    a = np.asarray(a[:3], np.float64)
    b = np.asarray(b[:3], np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    err = a - b
    mse = float(np.mean(err * err))
    return {
        "psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
        "rmse": float(np.sqrt(mse)),
        "max_abs": float(np.abs(err).max()),
    }


def compare_dirs(dir_a: str, dir_b: str) -> dict:
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    names = [n for n in names if n.lower().endswith((".png", ".jpg", ".tiff"))]
    if not names:
        raise ValueError("no common image files to compare")
    per_frame = {
        n: compare_images(
            read_image_rgba(os.path.join(dir_a, n)),
            read_image_rgba(os.path.join(dir_b, n)),
        )
        for n in names
    }
    psnrs = [v["psnr_db"] for v in per_frame.values()]
    return {
        "frames": len(names),
        "psnr_mean_db": float(np.mean(psnrs)),
        "psnr_min_db": float(np.min(psnrs)),
        "per_frame": per_frame,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir_a", required=True)
    p.add_argument("--dir_b", required=True)
    p.add_argument("--report", default="")
    p.add_argument("--min_psnr_db", type=float, default=0.0,
                   help="exit nonzero if any frame falls below this")
    args = p.parse_args(argv)
    setup_logging()
    report = compare_dirs(args.dir_a, args.dir_b)
    log.info(
        "%d frames: mean PSNR %.2f dB, min %.2f dB",
        report["frames"], report["psnr_mean_db"], report["psnr_min_db"],
    )
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    if args.min_psnr_db and report["psnr_min_db"] < args.min_psnr_db:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
