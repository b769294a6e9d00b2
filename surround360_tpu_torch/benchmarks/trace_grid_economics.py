"""Grid economics of the preset frame: the geometry of every fused window
kernel call site of one frame.

Port of ``benchmarks/trace_grid_economics.py``. The reference traces the
frame with ``jax.eval_shape`` and ``S360_LOG_FUSED=1``, so each call of
its Pallas sampler prints its grid, without compiling or running anything.
The port has no trace-only mode, so it runs the frame (priorless, on the
device asked for) with ``ops/fused_window.py``'s ``RECORD`` on, and prints
one line per (kernel, call site, offset set): the launches, and the
geometry of the launch with the most samples (tiles T, leads L, channels C,
samples a tile P, offsets O, window rows x columns, source array, filter
and border). By default the inputs are zeros of the cameras' shapes: the
shapes decide the geometry; the data moves the window origins only.

    python -m surround360_tpu_torch.benchmarks.trace_grid_economics [--device cpu]
Env: S360_PROF_EQR_WIDTH (6300), S360_PROF_CAM_SCALE (1.0),
S360_PROF_SIDE_FLOW_SCALE (0.5), S360_PROF_POLAR_FLOW_SCALE (0.25),
S360_PROF_FLOW_ALG (pixflow_tpu).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

__all__ = ["call_geometry", "run", "main"]


def call_geometry(key, entry) -> dict:
    """One ``fused_window.RECORD`` entry -> its geometry."""
    kernel, site, offsets = key
    args, kw, _, launches = entry
    padded, _, _, xt, _ = args
    T, L, P = (int(v) for v in xt.shape)
    wx = kw["bw"] if (kw.get("base_bw") is None or offsets) else kw["base_bw"]
    return dict(kernel=kernel, site=site, launches=launches, T=T, L=L,
                C=int(padded.shape[1]), P=P, O=len(offsets) if offsets else 1,
                bh=kw["bh"], wx=wx, src=tuple(int(v) for v in padded.shape[2:]),
                mode=f"{kw['interpolation']}/{kw['border']}")


def run(device, eqr_w=6300, cam_scale=1.0, side_flow_scale=0.5,
        polar_flow_scale=0.25, flow_alg="pixflow_tpu", ctx=None, inputs=None):
    """Render one frame with the kernels' record on; print and return one
    geometry dict per (kernel, site, offsets). ``ctx`` / ``inputs``: a
    prebuilt context and (side, top, bottom) on ``device``."""
    from ..geometry.rig import make_ring_rig
    from ..ops import fused_window as fw
    from ..render.panorama import RenderConfig, build_render_context, render_frame

    device = torch.device(device)
    if ctx is None:
        rig = make_ring_rig().rescaled(cam_scale)
        ctx = build_render_context(rig, RenderConfig(
            eqr_width=eqr_w, eqr_height=eqr_w // 2, side_flow_alg=flow_alg,
            polar_flow_alg=flow_alg, side_flow_scale=side_flow_scale,
            polar_flow_scale=polar_flow_scale, enable_top=True, enable_bottom=True))
    if inputs is None:
        rig = ctx.rig
        hw = lambda i: (int(rig.cameras[i].resolution[1]), int(rig.cameras[i].resolution[0]))
        side = torch.zeros((len(rig.side_ids), 4) + hw(rig.ids.index(rig.side_ids[0])),
                           device=device)
        pole = lambda i: torch.zeros((4,) + hw(i), device=device)
        inputs = (side, pole(rig.top_camera_index), pole(rig.bottom_camera_index))
    cfg = ctx.config
    print(f"# running the full frame @ {cfg.eqr_width}x{cfg.eqr_height}/eye on "
          f"{device.type}", file=sys.stderr, flush=True)
    saved, fw.RECORD = fw.RECORD, {}
    try:
        out, _ = render_frame(ctx, *inputs, state={})
        record = fw.RECORD
    finally:
        fw.RECORD = saved
    rows = [call_geometry(k, record[k]) for k in sorted(record, key=str)]
    del record
    for r in rows:
        print(f"{r['kernel']:22s} {r['site']:20s} x{r['launches']:<3d} T={r['T']} "
              f"L={r['L']} C={r['C']} P={r['P']} O={r['O']} window {r['bh']}x{r['wx']} "
              f"src {r['src'][0]}x{r['src'][1]} {r['mode']}")
    print(f"# ran ok: equirect {tuple(out['equirect'].shape)}")
    return rows


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = os.environ.get
    return run(
        resolve_device(args.device), int(env("S360_PROF_EQR_WIDTH", "6300")),
        float(env("S360_PROF_CAM_SCALE", "1.0")),
        float(env("S360_PROF_SIDE_FLOW_SCALE", "0.5")),
        float(env("S360_PROF_POLAR_FLOW_SCALE", "0.25")),
        env("S360_PROF_FLOW_ALG", "pixflow_tpu"),
    )


if __name__ == "__main__":
    main()
