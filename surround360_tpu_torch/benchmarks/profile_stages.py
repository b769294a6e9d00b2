"""Per-stage time breakdown of the frame pipeline (standalone).

Port of ``benchmarks/profile_stages.py``: a thin script over the port's
``render/profiling.py::stage_breakdown`` / ``format_breakdown``, the same
table ``cli/render_video --profile_stages`` logs (the reference's per-frame
stage log, TestRenderStereoPanorama.cpp:963-971). The simulator's frame is
rendered once without a prior, then ``reps`` times chained with tracing
on; the table is the mean of those frames' spans: each stage's host
milliseconds, its stream milliseconds (CUDA events; none on the CPU) and
the fused window kernels' launches, then the flow by pyramid level.

    python -m surround360_tpu_torch.benchmarks.profile_stages [--device cpu]
Env: S360_PROF_EQR_WIDTH (1008), S360_PROF_CAM_SCALE (0.25),
     S360_PROF_REPS (5), S360_PROF_FULL_SPHERE (1),
     S360_PROF_SIDE_FLOW_SCALE (1.0), S360_PROF_POLAR_FLOW_SCALE (0.25),
     S360_PROF_FLOW_ALG (pixflow_tpu).
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
    return dict(
        eqr_w=int(env("S360_PROF_EQR_WIDTH", "1008")),
        cam_scale=float(env("S360_PROF_CAM_SCALE", "0.25")),
        reps=int(env("S360_PROF_REPS", "5")),
        full_sphere=env("S360_PROF_FULL_SPHERE", "1") == "1",
        side_flow_scale=float(env("S360_PROF_SIDE_FLOW_SCALE", "1.0")),
        polar_flow_scale=float(env("S360_PROF_POLAR_FLOW_SCALE", "0.25")),
        flow_alg=env("S360_PROF_FLOW_ALG", "pixflow_tpu"),
    )


def run(device, eqr_w=1008, cam_scale=0.25, reps=5, full_sphere=True,
        side_flow_scale=1.0, polar_flow_scale=0.25, flow_alg="pixflow_tpu"):
    """Build the context at ``eqr_w`` x ``eqr_w // 2`` per eye from the ring
    rig's cameras scaled by ``cam_scale``, render the simulator's views
    (frame 0, then ``reps`` chained frames traced) and read the stage
    table. Prints the table and two JSON lines (host ms per row, launches
    per row); returns the rows of ``stage_breakdown``."""
    from ..capture import render_camera_views
    from ..geometry.rig import make_ring_rig
    from ..render.panorama import RenderConfig, build_render_context, render_frame
    from ..render.profiling import format_breakdown, stage_breakdown
    from ..utils import tracing

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
    _, state = render_frame(ctx, side, top, bottom)
    with tracing.recording():
        for _ in range(reps):
            _, state = render_frame(ctx, side, top, bottom, state=state, use_temporal=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rows = stage_breakdown(tracing.session())
    print(f"\n== stage breakdown @ {eqr_w}x{eqr_h}/eye, cams x{cam_scale}, "
          f"{device.type}, mean of {reps} chained frames ==")
    print(format_breakdown(rows))
    print(json.dumps({k: round(r["host_ms"], 1) for k, r in rows.items()}))
    print(json.dumps({k: {n: c for n, c in r["launches"].items() if c}
                      for k, r in rows.items()}))
    return rows


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run(resolve_device(args.device), **settings())


if __name__ == "__main__":
    main()
