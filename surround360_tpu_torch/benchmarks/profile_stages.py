"""Per-stage time breakdown of the frame pipeline (standalone).

Port of ``benchmarks/profile_stages.py``: a thin script over the port's
``render/profiling.py::stage_breakdown`` / ``format_breakdown``, the same
table ``cli/render_video --profile_stages`` logs (the reference's per-frame
stage log, TestRenderStereoPanorama.cpp:963-971). Each stage runs alone on
the simulator's frame; its time is CUDA events on the card (the host clock
on the CPU), with the fused window kernels' launches in one run of it.

    python -m surround360_tpu_torch.benchmarks.profile_stages [--device cpu]
Env: S360_PROF_EQR_WIDTH (1008), S360_PROF_CAM_SCALE (0.25),
     S360_PROF_REPS (5), S360_PROF_FULL_SPHERE (1),
     S360_PROF_SIDE_FLOW_SCALE (1.0), S360_PROF_POLAR_FLOW_SCALE (0.25),
     S360_PROF_FLOW_ALG (pixflow_tpu), S360_PROF_STAGES (csv of stage
     names; default all).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

__all__ = ["settings", "run", "main"]


def settings() -> dict:
    """The reference's S360_PROF_* settings, with its defaults."""
    env = os.environ.get
    stages = {s.strip() for s in env("S360_PROF_STAGES", "").split(",") if s.strip()}
    return dict(
        eqr_w=int(env("S360_PROF_EQR_WIDTH", "1008")),
        cam_scale=float(env("S360_PROF_CAM_SCALE", "0.25")),
        reps=int(env("S360_PROF_REPS", "5")),
        full_sphere=env("S360_PROF_FULL_SPHERE", "1") == "1",
        side_flow_scale=float(env("S360_PROF_SIDE_FLOW_SCALE", "1.0")),
        polar_flow_scale=float(env("S360_PROF_POLAR_FLOW_SCALE", "0.25")),
        flow_alg=env("S360_PROF_FLOW_ALG", "pixflow_tpu"),
        stages=stages or None,
    )


def run(device, eqr_w=1008, cam_scale=0.25, reps=5, full_sphere=True,
        side_flow_scale=1.0, polar_flow_scale=0.25, flow_alg="pixflow_tpu",
        stages=None):
    """Build the context at ``eqr_w`` x ``eqr_w // 2`` per eye from the ring
    rig's cameras scaled by ``cam_scale``, render the simulator's views and
    time each stage. Prints the table and two JSON lines (ms per stage,
    launches per stage); returns (times, launches) as ``stage_breakdown``."""
    from ..capture import render_camera_views
    from ..geometry.rig import make_ring_rig
    from ..render.panorama import RenderConfig, build_render_context
    from ..render.profiling import format_breakdown, stage_breakdown

    device = torch.device(device)
    eqr_h = eqr_w // 2
    rig = make_ring_rig().rescaled(cam_scale)
    cfg = RenderConfig(
        eqr_width=eqr_w, eqr_height=eqr_h, side_flow_alg=flow_alg,
        polar_flow_alg=flow_alg, side_flow_scale=side_flow_scale,
        polar_flow_scale=polar_flow_scale, enable_top=full_sphere,
        enable_bottom=full_sphere,
    )
    ctx = build_render_context(rig, cfg)
    views = render_camera_views(rig)
    to_dev = lambda a: torch.from_numpy(a).to(device)
    side = to_dev(np.stack([views[rig.ids.index(s)] for s in rig.side_ids]))
    top = to_dev(views[rig.top_camera_index]) if full_sphere else None
    bottom = to_dev(views[rig.bottom_camera_index]) if full_sphere else None
    times, launches = stage_breakdown(ctx, side, top, bottom, reps=reps, stages=stages)
    print(f"\n== stage breakdown @ {eqr_w}x{eqr_h}/eye, cams x{cam_scale}, "
          f"{device.type} ==")
    print(format_breakdown(times, launches))
    print(json.dumps({k: round(v * 1e3, 1) for k, v in times.items()}))
    print(json.dumps({k: {n: c for n, c in v.items() if c} for k, v in launches.items()}))
    return times, launches


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run(resolve_device(args.device), **settings())


if __name__ == "__main__":
    main()
