"""Calibration CLI drivers.

Port of ``surround360_tpu/cli/calibrate.py`` (rebuilds of
scripts/geometric_calibration.py, scripts/color_calibrate_all.py and
scripts/vignetting_calibrate.py):

  python -m surround360_tpu_torch.cli.calibrate geometric ...
  python -m surround360_tpu_torch.cli.calibrate color ...
  python -m surround360_tpu_torch.cli.calibrate vignetting ...

Each sub-command takes ``--device`` (default ``cuda``; ``cpu`` to run on
the host). COLMAP remains an optional external feature matcher (its sqlite
database is converted with colmap_db_to_matches_json); without it, the
built-in ORB matcher builds the match graph from the frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..calib.color import delta_e_report, detect_color_chart, solve_isp_color_params
from ..calib.geometric import (
    GeometricCalibrationConfig,
    calibrate_geometric,
    generate_artificial_points,
    perturb_rig,
)
from ..calib.matches import assemble_traces, load_matches_json, match_keypoints
from ..calib.vignetting import acquire_vignetting_samples, fit_vignetting
from ..geometry.camera import overlap
from ..geometry.rig import load_rig, save_rig
from ..isp import load_isp_config
from .common import log, read_image_rgba, resolve_device, setup_logging

MIN_OVERLAP = 0.05  # camera pairs matched by the built-in matcher
MIN_PAIR_MATCHES = 8  # a pair with fewer matches adds nothing
READ_THREADS = 8  # sweep frames decoded at once (zlib and numpy release the GIL)


def match_frames(rig, images: dict, device):
    """The built-in matcher over every camera pair that overlaps by at
    least MIN_OVERLAP: (keypoints {cam id: (K, 2)}, matches [(id_a, id_b,
    (M, 2) index pairs)]). Each pair's keypoints are appended afresh, as
    the reference does, so no trace spans more than two views."""
    keypoints, matches = {}, []
    for i, id_a in enumerate(rig.ids):
        for j in range(i + 1, len(rig.ids)):
            id_b = rig.ids[j]
            if overlap(rig.cameras[i], rig.cameras[j]) < MIN_OVERLAP:
                continue
            pts_a, pts_b = match_keypoints(images[id_a], images[id_b], device=device)
            if len(pts_a) < MIN_PAIR_MATCHES:
                continue
            base_a = len(keypoints.setdefault(id_a, np.zeros((0, 2))))
            base_b = len(keypoints.setdefault(id_b, np.zeros((0, 2))))
            keypoints[id_a] = np.concatenate([keypoints[id_a], pts_a])
            keypoints[id_b] = np.concatenate([keypoints[id_b], pts_b])
            matches.append((
                id_a,
                id_b,
                np.stack(
                    [base_a + np.arange(len(pts_a)), base_b + np.arange(len(pts_b))],
                    axis=1,
                ),
            ))
    return keypoints, matches


def run_geometric(args):
    device = resolve_device(args.device)
    rig = load_rig(args.rig_json)

    if args.unit_test:
        # synthetic self-test (GeometricCalibration --unit_test analog):
        # perturb the rig, recover it from artificial points, report RMSE
        obs, _ = generate_artificial_points(rig, args.num_points)
        bad = perturb_rig(rig, rotation_amount=args.perturb_rotation)
        cfg = GeometricCalibrationConfig(passes=args.pass_count)
        refined, report = calibrate_geometric(bad, obs, cfg, verbose=True, device=device)
        log.info("final report: %s", report)
        if args.output_json:
            save_rig(args.output_json, refined)
        return

    if args.matches_json:
        keypoints, matches = load_matches_json(args.matches_json)
        image_to_camera = {
            name: rig.ids.index(os.path.splitext(os.path.basename(name))[0])
            for name in keypoints
        }
    else:
        images = {}
        for cam_id in rig.ids:
            path = os.path.join(args.frames_dir, cam_id + ".png")
            if not os.path.exists(path):
                path = os.path.join(
                    args.frames_dir, cam_id, f"{args.frame_number:06d}.png"
                )
            images[cam_id] = read_image_rgba(path)
        keypoints, matches = match_frames(rig, images, device)
        image_to_camera = {cam_id: i for i, cam_id in enumerate(rig.ids)}
        log.info(
            "matched %d camera pairs: %d matches", len(matches),
            sum(len(m[2]) for m in matches),
        )

    obs = assemble_traces(keypoints, matches, image_to_camera)
    log.info(
        "assembled %d observations over %d traces", len(obs.cam_idx), obs.num_points
    )
    cfg = GeometricCalibrationConfig(passes=args.pass_count)
    refined, report = calibrate_geometric(rig, obs, cfg, verbose=True, device=device)
    log.info("final report: %s", report)
    save_rig(args.output_json, refined)


def run_color(args):
    """One ISP JSON per chart image (``<serial>.json``): the chart detected,
    black level, white balance and CCM solved, written over
    ``--base_isp_json``, and the DeltaE of the corrected patch medians
    logged. Images are read by the package's codecs (PNG, JPEG, TIFF)."""
    device = resolve_device(args.device)
    os.makedirs(args.output_isp_dir, exist_ok=True)
    for name in sorted(os.listdir(args.charts_dir)):
        if not name.lower().endswith((".png", ".tiff", ".tif", ".jpg")):
            continue
        serial = os.path.splitext(name)[0]
        img = read_image_rgba(os.path.join(args.charts_dir, name))[:3]
        centroids, medians = detect_color_chart(img, device=device)
        result = solve_isp_color_params(
            medians, centroids, illuminant=args.illuminant, device=device
        )
        base = load_isp_config(args.base_isp_json or {"CameraIsp": {}})
        cfg = dataclasses.replace(
            base,
            black_level=tuple(float(b * base.max_pixel_value) for b in result.black_level),
            white_balance_gain=tuple(map(float, result.white_balance)),
            ccm=tuple(tuple(map(float, row)) for row in result.ccm),
        )
        out_path = os.path.join(args.output_isp_dir, f"{serial}.json")
        with open(out_path, "w") as f:
            json.dump(cfg.to_json(), f, indent=2)
        # quality report on corrected medians
        corrected = (
            (medians - result.black_level) / (1.0 - result.black_level)
            * result.white_balance
        ) @ np.asarray(result.ccm).T
        rep = delta_e_report(corrected, args.illuminant)
        log.info("%s: deltaE mean %.2f max %.2f -> %s",
                 serial, rep["mean"], rep["max"], out_path)


def run_vignetting(args):
    device = resolve_device(args.device)
    paths = [os.path.join(args.sweep_dir, name) for name in sorted(os.listdir(args.sweep_dir))
             if name.lower().endswith((".png", ".tiff", ".tif"))]
    with ThreadPoolExecutor(READ_THREADS) as pool:
        # the green plane; copied so the rest of the frame is freed
        imgs = list(pool.map(lambda p: read_image_rgba(p)[1].copy(), paths))
    locations, intensities = acquire_vignetting_samples(imgs, device=device)
    H, W = imgs[0].shape
    fit = fit_vignetting(locations, intensities, (W, H), device=device)
    log.info("vignetting fit rms residual: %.5f", fit.rms_residual)

    base = load_isp_config(args.base_isp_json or {"CameraIsp": {}})
    cfg = dataclasses.replace(
        base,
        vignette_rolloff_h=tuple(tuple(map(float, r)) for r in fit.rolloff_h),
        vignette_rolloff_v=tuple(tuple(map(float, r)) for r in fit.rolloff_v),
    )
    os.makedirs(os.path.dirname(args.output_isp_json) or ".", exist_ok=True)
    with open(args.output_isp_json, "w") as f:
        json.dump(cfg.to_json(), f, indent=2)
    log.info("wrote %s", args.output_isp_json)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    g = sub.add_parser("geometric", parents=[common])
    g.add_argument("--rig_json", required=True)
    g.add_argument("--output_json", default="")
    g.add_argument("--matches_json", default="")
    g.add_argument("--frames_dir", default="")
    g.add_argument("--frame_number", type=int, default=0)
    g.add_argument("--pass_count", type=int, default=10)
    g.add_argument("--unit_test", action="store_true")
    g.add_argument("--num_points", type=int, default=1000)
    g.add_argument("--perturb_rotation", type=float, default=0.01)

    c = sub.add_parser("color", parents=[common])
    c.add_argument("--charts_dir", required=True)
    c.add_argument("--output_isp_dir", required=True)
    c.add_argument("--illuminant", default="D50", choices=["D50", "D65"])
    c.add_argument("--base_isp_json", default="")

    v = sub.add_parser("vignetting", parents=[common])
    v.add_argument("--sweep_dir", required=True)
    v.add_argument("--output_isp_json", required=True)
    v.add_argument("--base_isp_json", default="")

    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    if args.cmd == "geometric":
        run_geometric(args)
    elif args.cmd == "color":
        run_color(args)
    else:
        run_vignetting(args)


if __name__ == "__main__":
    main()
