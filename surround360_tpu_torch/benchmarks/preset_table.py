"""Quality-preset benchmark: ms per frame, fps and peak device memory per
preset.

Port of ``benchmarks/preset_table.py``. Renders the synthetic capture
through the full pipeline at the reference's quality-preset geometries
(batch_process_video.py:176-199, ``cli/render_video.py::QUALITY_PRESETS``)
from full-resolution 2048 px cameras, through
``render/panorama.py::make_jitted_renderer``, and records the host-clock
seconds of each synchronized frame and the peak device memory
(``torch.cuda.max_memory_allocated``, reset per preset). The first frames
(``compile_s``, the reference's key) compile nothing here: they are the
host's static-warp planning and first use.

Modes: priorless (every frame alone), temporal (S360_PRESET_TEMPORAL=1:
frame 0 priorless, a warm temporal frame, then ``reps`` frames chained
through the temporal state, the reference's frame chain,
TestRenderStereoPanorama.cpp:210-256), +cubemap (S360_PRESET_CUBEMAP=1:
faces eqr_height / 2 square). Each row also gives the timed frames' ms
and their median.

    python -m surround360_tpu_torch.benchmarks.preset_table [--device cpu]
Env: S360_PRESETS ("3k,6k"), S360_PRESET_REPS (3), S360_PRESET_CAM_SCALE
(1.0), S360_PRESET_TEMPORAL (0), S360_PRESET_CUBEMAP (0).

A preset that fails (out of memory, say) becomes a row with an ``error``
and the table goes on, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

__all__ = ["preset_config", "frame_inputs", "run", "format_table", "main"]


def preset_config(name: str, cubemap: bool = False, final: bool = True,
                  flow_alg: str = "pixflow_tpu", **overrides):
    """The RenderConfig of quality preset ``name``: its render and final
    geometry, the preset sharpening and side-flow scale, ``flow_alg`` on
    the ring and the poles, both poles; ``final=False`` drops sharpening
    and the final resize."""
    from ..cli.render_video import PRESET_SHARPENING, PRESET_SIDE_FLOW_SCALE, QUALITY_PRESETS
    from ..render.panorama import RenderConfig

    eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[name]
    kw = dict(
        eqr_width=eqr_w, eqr_height=eqr_h, side_flow_alg=flow_alg,
        polar_flow_alg=flow_alg, side_flow_scale=PRESET_SIDE_FLOW_SCALE.get(name, 1.0),
        enable_top=True, enable_bottom=True,
        cubemap_width=eqr_h // 2 if cubemap else 0,
        cubemap_height=eqr_h // 2 if cubemap else 0,
    )
    if final:
        kw.update(final_eqr_width=fin_w, final_eqr_height=fin_h,
                  sharpening=PRESET_SHARPENING)
    kw.update(overrides)
    return RenderConfig(**kw)


def frame_inputs(rig, views, device):
    """(side, top, bottom) tensors on ``device`` from the simulator's views."""
    to_dev = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    side = to_dev(np.stack([views[rig.ids.index(s)] for s in rig.side_ids]))
    return side, to_dev(views[rig.top_camera_index]), to_dev(views[rig.bottom_camera_index])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _preset_row(ctx, inputs, device, reps, temporal):
    from ..render.panorama import make_jitted_renderer

    def frame(render, state):
        t0 = time.perf_counter()
        out, state = render(*inputs, state)
        _sync(device)
        return out, state, time.perf_counter() - t0

    t0 = time.perf_counter()
    times = []
    if temporal:
        render0 = make_jitted_renderer(ctx, use_temporal=False)
        render_t = make_jitted_renderer(ctx, use_temporal=True)
        out, state, _ = frame(render0, None)
        out, state, _ = frame(render_t, state)  # warm
        first_s = time.perf_counter() - t0
        for _ in range(reps):
            out, state, secs = frame(render_t, state)
            times.append(secs)
    else:
        render = make_jitted_renderer(ctx)
        # [0] drops the state at once: only the outputs stay alive
        out, _, _ = frame(render, None)
        first_s = time.perf_counter() - t0
        for _ in range(reps):
            out, _, secs = frame(render, None)
            times.append(secs)
    return out, first_s, times


def run(device, presets=("3k", "6k"), reps=3, cam_scale=1.0, temporal=False,
        cubemap=False, rig=None, views=None, contexts=None):
    """One row per preset (see the module docstring). ``rig`` / ``views``:
    the ring rig and the simulator's views (made here when None);
    ``contexts``: prebuilt render contexts by preset name. Returns the rows
    as the reference's dicts plus ``frames_ms`` and ``median_ms``."""
    from ..capture import render_camera_views
    from ..geometry.rig import make_ring_rig
    from ..render.panorama import build_render_context

    device = torch.device(device)
    if rig is None:
        rig = make_ring_rig().rescaled(cam_scale)
    if views is None:
        views = render_camera_views(rig)
    inputs = frame_inputs(rig, views, device)
    rows = []
    for name in (p.strip() for p in presets):
        try:
            ctx = (contexts or {}).get(name) or build_render_context(
                rig, preset_config(name, cubemap=cubemap))
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            out, first_s, times = _preset_row(ctx, inputs, device, reps, temporal)
            if not all(bool(torch.isfinite(v).all()) for k, v in out.items() if k != "debug"):
                raise FloatingPointError("non-finite output")
        except Exception as e:  # noqa: BLE001 - an OOM or a failure becomes a row
            rows.append({"preset": name, "error": f"{type(e).__name__}: {e}"[:200]})
            print(f"{name}: FAILED {type(e).__name__}", flush=True)
            continue
        cfg = ctx.config
        ms = sum(times) / len(times) * 1e3
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else float("nan"))
        rows.append({
            "preset": name,
            "mode": ("temporal" if temporal else "priorless") + ("+cubemap" if cubemap else ""),
            "eqr": f"{cfg.eqr_width}x{cfg.eqr_height}/eye",
            "ms_per_frame": round(ms, 1),
            "fps": round(1e3 / ms, 3),
            "compile_s": round(first_s, 1),
            "peak_hbm_gb": round(peak, 2),
            "frames_ms": [round(t * 1e3, 1) for t in times],
            "median_ms": round(statistics.median(times) * 1e3, 1),
            "device": device.type,
        })
        print(json.dumps(rows[-1]), flush=True)
        del out, ctx
    print(format_table(rows))
    return rows


def format_table(rows) -> str:
    lines = ["\n| preset | eqr/eye | ms/frame | fps | peak HBM (GB) |", "|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['preset']} | — | FAILED: {r['error']} | | |")
        else:
            lines.append(f"| {r['preset']} | {r['eqr']} | {r['ms_per_frame']} | "
                         f"{r['fps']} | {r['peak_hbm_gb']} |")
    return "\n".join(lines)


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = os.environ.get
    return run(
        resolve_device(args.device), env("S360_PRESETS", "3k,6k").split(","),
        int(env("S360_PRESET_REPS", "3")), float(env("S360_PRESET_CAM_SCALE", "1.0")),
        env("S360_PRESET_TEMPORAL", "0") == "1", env("S360_PRESET_CUBEMAP", "0") == "1",
    )


if __name__ == "__main__":
    main()
