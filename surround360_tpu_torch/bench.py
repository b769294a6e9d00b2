"""Benchmark: full stereo panorama render throughput on one NVIDIA GPU.

Port of the reference's root ``bench.py``:

    python -m surround360_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line, the last on stdout: {"metric", "value", "unit",
"vs_baseline"}, with ``value`` in frames/sec and ``vs_baseline`` = fps /
30 (the north star: 30 fps of 8K stereo equirect), the reference's keys
and ``metric`` strings. ``--device cuda`` is the default and raises
without CUDA.

Default = the 6k quality preset at the reference's video semantics: full
2048 px cameras, 6300x3072 per eye rendered -> 6144x6144 final,
sharpening 0.25, ``pixflow_tpu`` on the ring and the poles, both poles,
frames chained through the temporal flow prior
(TestRenderStereoPanorama.cpp:210-256, batch_process_video.py:188-193).
Frame 0 and one temporal frame warm up; then S360_BENCH_FRAMES (3)
temporal frames are launched back to back and the device is synchronized
once, after the last: fps = frames / wall seconds. The simulator's views
are rendered on host threads before, outside the timed window.

Env, as in the reference: S360_BENCH_PRESET (6k; 3k / 4k / 8k, or ``off``
for the legacy mode), S360_BENCH_FRAMES, S360_BENCH_TIMEOUT_S (5400: the
watchdog prints a zero-value line and exits 2), S360_BENCH_MEMSTATS=1
(peak device memory to stderr, with the hand kernels' launch counts).
Legacy mode: S360_BENCH_EQR_WIDTH (1008), S360_BENCH_CAM_SCALE (0.25 ->
512 px cameras), S360_BENCH_FRAMES (5), S360_BENCH_FULL_SPHERE=0/1 (1),
S360_BENCH_BATCH (8), S360_BENCH_TEMPORAL=0/1 (1), S360_BENCH_FLOW_ALG
(pixflow_tpu). A batch of frames (the reference's ``lax.scan`` chain with
the temporal prior, or its ``vmap`` of independent frames without it)
is a loop over the batch's frames on one device, synchronized once a
batch; batch 1 synchronizes every frame.

The reference's persistent compilation cache has no counterpart: the
port compiles nothing per frame, and its CUDA kernels build into
``surround360_tpu_torch/_build/`` at first use, inside the watchdog's
budget.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["preset_metric", "legacy_metric", "render_views", "main"]

VIEW_THREADS = 8


def _install_watchdog(seconds: int):
    """A wedged card (or a hung build) must still end with the one JSON
    line: SIGALRM prints a zero-value line and exits with status 2."""

    def on_alarm(signum, frame):
        print(
            json.dumps(
                {
                    "metric": "stereo equirect render fps (bench watchdog: "
                    "GPU unavailable/wedged, no measurement)",
                    "value": 0.0,
                    "unit": "frames/sec",
                    "vs_baseline": 0.0,
                }
            ),
            flush=True,
        )
        os._exit(2)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)


def render_views(rig):
    """The capture simulator's views of every camera of ``rig``
    (``render_camera_views`` with its default scene), one camera a host
    thread (numpy releases the interpreter lock)."""
    from .capture import render_camera_views
    from .geometry.rig import Rig

    def one(i):
        return render_camera_views(Rig([rig.cameras[i]], [rig.ids[i]], ["side camera"]))[0]

    with ThreadPoolExecutor(VIEW_THREADS) as pool:
        return list(pool.map(one, range(len(rig.cameras))))


def preset_metric(preset: str) -> str:
    """The preset mode's ``metric`` string (the reference's, :124-129)."""
    from .cli.render_video import QUALITY_PRESETS

    eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[preset]
    return (
        f"stereo equirect render fps ({preset} preset {eqr_w}x{eqr_h}/eye"
        f" -> {fin_w}x{fin_h} final, 2048px cams, full pipeline incl. 28 "
        f"pair flows + top/bottom pole composite + sharpen 0.25, temporal"
        f" frame chain, 1 chip)"
    )


def legacy_metric(eqr_w: int, eqr_h: int, full_sphere: bool, frame_batch: int,
                  temporal: bool) -> str:
    """The legacy mode's ``metric`` string (the reference's, :262-271)."""
    return (
        f"stereo equirect render fps ({eqr_w}x{eqr_h} per eye, "
        f"full pipeline incl. 28 pair flows"
        f"{' + top/bottom pole composite' if full_sphere else ''}"
        f"{f', batch {frame_batch}' if frame_batch > 1 else ''}"
        f"{', temporal chain' if (frame_batch > 1 and temporal) else ''}, "
        f"1 chip)"
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _memstats(device):
    """The reference's S360_BENCH_MEMSTATS line, and the launches of the
    port's hand kernels since the counts were last reset."""
    from .ops import fused_window as fw

    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        total = torch.cuda.get_device_properties(device).total_memory
        print(f"# peak HBM {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB",
              file=sys.stderr)
    launches = {k: fw.launch_count(k) for k in fw.KERNELS}
    print(f"# kernel launches {json.dumps(launches)}", file=sys.stderr, flush=True)


def _preset_bench(preset: str, device):
    """fps of the full preset pipeline with the temporal frame chain."""
    from .benchmarks.preset_table import frame_inputs, preset_config
    from .geometry.rig import make_ring_rig
    from .ops import fused_window as fw
    from .render.panorama import build_render_context, make_jitted_renderer

    n_frames = int(os.environ.get("S360_BENCH_FRAMES", "3"))
    rig = make_ring_rig()
    side, top, bottom = frame_inputs(rig, render_views(rig), device)
    ctx = build_render_context(rig, preset_config(preset))
    render0 = make_jitted_renderer(ctx, use_temporal=False)
    render_t = make_jitted_renderer(ctx, use_temporal=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fw.reset_launch_counts()
    out, state = render0(side, top, bottom, None)
    _sync(device)
    out, state = render_t(side, top, bottom, state)  # warm
    _sync(device)
    t0 = time.perf_counter()
    outs = []
    for _ in range(n_frames):
        # launched back to back and synchronized once at the end: every
        # frame still renders (its outputs are kept and the temporal state
        # chains them), as the video CLI overlaps a frame with its IO
        out, state = render_t(side, top, bottom, state)
        outs.append(out["equirect"])
    _sync(device)
    fps = n_frames / (time.perf_counter() - t0)
    if os.environ.get("S360_BENCH_MEMSTATS") == "1":
        _memstats(device)
    return fps, preset_metric(preset)


def _legacy_bench(device):
    """The reference's small-scale batch mode (bench.py:155-279)."""
    from .benchmarks.preset_table import frame_inputs
    from .geometry.rig import make_ring_rig
    from .ops import fused_window as fw
    from .render.panorama import (
        RenderConfig,
        build_render_context,
        make_jitted_renderer,
        render_frame,
    )

    env = os.environ.get
    eqr_w = int(env("S360_BENCH_EQR_WIDTH", "1008"))
    cam_scale = float(env("S360_BENCH_CAM_SCALE", "0.25"))
    n_frames = int(env("S360_BENCH_FRAMES", "5"))
    full_sphere = env("S360_BENCH_FULL_SPHERE", "1") == "1"
    frame_batch = int(env("S360_BENCH_BATCH", "8"))
    temporal = env("S360_BENCH_TEMPORAL", "1") == "1"
    eqr_h = eqr_w // 2

    rig = make_ring_rig().rescaled(cam_scale)
    cfg = RenderConfig(
        eqr_width=eqr_w,
        eqr_height=eqr_h,
        side_flow_alg=env("S360_BENCH_FLOW_ALG", "pixflow_tpu"),
        polar_flow_alg=env("S360_BENCH_FLOW_ALG", "pixflow_tpu"),
        enable_top=full_sphere,
        enable_bottom=full_sphere,
    )
    ctx = build_render_context(rig, cfg)
    side, top, bottom = frame_inputs(rig, render_views(rig), device)
    if not full_sphere:
        top = bottom = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fw.reset_launch_counts()

    if frame_batch > 1:

        def render_batch():
            # temporal: frame 0 priorless, the rest chained through the
            # flow prior (the reference's lax.scan); otherwise every frame
            # alone (its vmap)
            outs, state = [], None
            for _ in range(frame_batch):
                out, new_state = render_frame(ctx, side, top, bottom, state=state,
                                              use_temporal=state is not None)
                outs.append(out["equirect"])
                state = new_state if temporal else None
            return outs

        render_batch()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_frames):
            render_batch()
            _sync(device)  # one sync a batch
        fps = n_frames * frame_batch / (time.perf_counter() - t0)
    else:
        render = make_jitted_renderer(ctx)
        render(side, top, bottom, None)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_frames):
            render(side, top, bottom, None)
            _sync(device)  # sync point per frame
        fps = n_frames / (time.perf_counter() - t0)
    if env("S360_BENCH_MEMSTATS") == "1":
        _memstats(device)
    return fps, legacy_metric(eqr_w, eqr_h, full_sphere, frame_batch, temporal)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    _install_watchdog(int(os.environ.get("S360_BENCH_TIMEOUT_S", "5400")))
    from .cli.common import resolve_device

    try:
        device = resolve_device(args.device)
        preset = os.environ.get("S360_BENCH_PRESET", "6k")
        if preset and preset != "off":
            fps, metric = _preset_bench(preset, device)
        else:
            fps, metric = _legacy_bench(device)
    finally:
        signal.alarm(0)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(fps, 3),
                "unit": "frames/sec",
                "vs_baseline": round(fps / 30.0, 4),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
