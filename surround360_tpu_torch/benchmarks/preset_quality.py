"""Full-sphere quality at the reference's preset geometries.

Port of ``benchmarks/preset_quality.py``. Renders the synthetic capture
through the full pipeline (28 pair flows, both pole composites) at each
quality preset's render geometry with ``pixflow_tpu`` and scores PSNR
against the capture simulator's analytic equirect
(``capture/simulator.py::render_equirect_reference``, full sphere):
both eyes over the whole sphere, the left eye over the side band and the
polar caps, and left against right. Sharpening and the final resize are
off: they change pixels relative to the analytic reference by design.
S360_PRESET_TEMPORAL=N chains N frames through the temporal prior (frame
1 priorless, frames 2..N temporal, through ``make_jitted_renderer``) and
scores the last.

    python -m surround360_tpu_torch.benchmarks.preset_quality [--device cpu]
Env: S360_PRESETS ("3k,4k,6k,8k"), S360_PRESET_CAM_SCALE (1.0),
S360_POLAR_FLOW_SCALE (the RenderConfig default, 0.25),
S360_SIDE_FLOW_SCALE (the preset's), S360_PRESET_TEMPORAL (1).

A preset that fails becomes a row with an ``error`` and the table goes on,
as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

__all__ = ["psnr", "quality_row", "run", "format_table", "main"]


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def quality_row(name, ctx, eqr, expect) -> dict:
    """The reference's row: ``eqr`` the (3, 2 h, w) stereo output, ``expect``
    the analytic full-sphere equirect (3, h, w)."""
    eqr_h = ctx.config.eqr_height
    left, right = eqr[:, :eqr_h], eqr[:, eqr_h:]
    pad = (eqr_h - ctx.strip_h) // 2
    band = slice(pad, pad + ctx.strip_h)
    caps = np.ones(eqr_h, bool)
    caps[band] = False
    return {
        "preset": name,
        "eqr": f"{ctx.config.eqr_width}x{eqr_h}/eye",
        "psnr_full_L": round(psnr(left, expect), 1),
        "psnr_full_R": round(psnr(right, expect), 1),
        "psnr_band_L": round(psnr(left[:, band], expect[:, band]), 1),
        "psnr_caps_L": round(psnr(left[:, caps], expect[:, caps]), 1),
        "lr_agreement": round(psnr(left, right), 1),
    }


def run(device, presets=("3k", "4k", "6k", "8k"), cam_scale=1.0, n_chain=1,
        polar_flow_scale=None, side_flow_scale=None, rig=None, views=None):
    """One row per preset (see the module docstring); ``rig`` / ``views``:
    the ring rig and the simulator's views (made here when None)."""
    from ..capture import render_camera_views, render_equirect_reference
    from ..cli.render_video import PRESET_SIDE_FLOW_SCALE
    from ..geometry.rig import make_ring_rig
    from ..render.panorama import build_render_context, make_jitted_renderer
    from .preset_table import frame_inputs, preset_config

    device = torch.device(device)
    if rig is None:
        rig = make_ring_rig().rescaled(cam_scale)
    if views is None:
        views = render_camera_views(rig)
    inputs = frame_inputs(rig, views, device)
    rows = []
    for name in (p.strip() for p in presets):
        kw = {} if polar_flow_scale is None else {"polar_flow_scale": polar_flow_scale}
        kw["side_flow_scale"] = (PRESET_SIDE_FLOW_SCALE.get(name, 1.0)
                                 if side_flow_scale is None else side_flow_scale)
        try:
            ctx = build_render_context(rig, preset_config(name, final=False, **kw))
            out, state = make_jitted_renderer(ctx)(*inputs, None)
            if n_chain > 1:
                render_t = make_jitted_renderer(ctx, use_temporal=True)
                for _ in range(n_chain - 1):
                    out, state = render_t(*inputs, state)
            eqr = out["equirect"].cpu().numpy()
        except Exception as e:  # noqa: BLE001 - an OOM or a failure becomes a row
            rows.append({"preset": name, "error": f"{type(e).__name__}: {e}"[:200]})
            print(f"{name}: FAILED {type(e).__name__}", flush=True)
            continue
        del out, state
        expect = render_equirect_reference(ctx, full_sphere=True)
        rows.append(quality_row(name, ctx, eqr, expect))
        print(json.dumps(rows[-1]), flush=True)
        del ctx
    print(format_table(rows))
    return rows


def format_table(rows) -> str:
    lines = ["\n| preset | eqr/eye | full L/R (dB) | band L | caps L | L-R |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['preset']} | — | FAILED: {r['error']} | | | |")
        else:
            lines.append(f"| {r['preset']} | {r['eqr']} | {r['psnr_full_L']}/"
                         f"{r['psnr_full_R']} | {r['psnr_band_L']} | "
                         f"{r['psnr_caps_L']} | {r['lr_agreement']} |")
    return "\n".join(lines)


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = os.environ.get
    opt = lambda k: float(env(k)) if env(k) else None
    return run(
        resolve_device(args.device), env("S360_PRESETS", "3k,4k,6k,8k").split(","),
        float(env("S360_PRESET_CAM_SCALE", "1.0")), int(env("S360_PRESET_TEMPORAL", "1")),
        opt("S360_POLAR_FLOW_SCALE"), opt("S360_SIDE_FLOW_SCALE"),
    )


if __name__ == "__main__":
    main()
