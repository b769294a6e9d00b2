"""Smoke run of surround360_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the
final line):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off (the reference is float32).
2. build: builds the fused window kernel from
   surround360_tpu_torch/csrc/ with nvcc into surround360_tpu_torch/_build/.
3. kernel vs twin at small shapes: every interpolation x border
   combination, tight and plain windows, origins at the array edges, NaN
   and +-1e6 coordinates, a sample count that is no multiple of 32;
   max-abs <= 2e-5.
4. main path: the 6k quality preset (6300x3072 per eye from 2048 px
   cameras, 6144x6144 final), pixflow_tpu flows, both poles merged,
   sharpening and the final resize; frame 0, then frame 1 chained through
   frame 0's temporal state. Requires the output shape, finite values and
   kernel launches at all four call sites; prints seconds and peak memory.
5. main-path kernel vs twin: one recorded call per call site, rerun
   through the plain PyTorch twin; max-abs <= 2e-5; kernel and twin ms.
6. quality: one more frame at the same geometry without sharpening or
   final resize; full-sphere PSNR per eye against the analytic reference
   must reach 40 dB.

Then the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

TOL = 2e-5  # kernel vs twin: same f32 tap math, FMA contraction differs
PSNR_MIN = 40.0  # the reference package's preset-quality target
PRESET = "6k"
SITES = ("side_projection", "novel_view", "fisheye_strip", "pole_warp")
REPLACES = "surround360_tpu/ops/pallas_remap.py:640"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | tf32 off")
    return smi


def phase_build():
    from surround360_tpu_torch.ops import fused_window as fw

    fw._load_library()
    log(f"[2 build] fused_window_sample built in {fw.BUILD_SECONDS:.1f} s")


def _small_cases(rng):
    """Kernel inputs covering the borders, window modes and edge cases."""
    L, C, Hp, Wp, T, P = 3, 4, 48, 300, 5, 77
    padded = rng.random((L, C, Hp, Wp), dtype=np.float32)
    for interp in ("bicubic", "bilinear"):
        for border in ("constant", "clamp"):
            for tight in (False, True):
                bh = 24
                bw, base_bw = (256, 61) if tight else (128, None)
                wx = base_bw or bw
                sy = rng.integers(0, Hp - bh + 1, (T, L)).astype(np.int32)
                sx = rng.integers(0, Wp - wx + 1, (T, L)).astype(np.int32)
                sy[0], sx[0] = 0, 0  # origins at the array edges
                sy[1], sx[1] = Hp - bh, Wp - wx
                xt = sx[..., None] + rng.uniform(-5, wx + 5, (T, L, P))
                yt = sy[..., None] + rng.uniform(-5, bh + 5, (T, L, P))
                xt, yt = xt.astype(np.float32), yt.astype(np.float32)
                xt[2, :, :3] = [np.nan, 1e6, -1e6]
                yt[3, :, :3] = [-1e6, np.nan, 1e6]
                kw = dict(bh=bh, bw=bw, pad_y=4, pad_x=6, n_y=Hp - 8,
                          n_x=Wp - 12, interpolation=interp, border=border,
                          base_bw=base_bw)
                yield f"{interp}/{border}/{'tight' if tight else 'plain'}", (
                    padded, sy, sx, xt, yt), kw


def phase_small():
    import torch

    from surround360_tpu_torch.ops import fused_window as fw

    worst = 0.0
    rng = np.random.default_rng(0)
    for name, arrays, kw in _small_cases(rng):
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        got = fw.fused_window_sample(*dev, **kw)
        torch.cuda.synchronize()
        want = fw.fused_window_sample_reference(*dev, **kw)
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > TOL:
            raise AssertionError(f"kernel vs twin {name}: max-abs {err}")
        worst = max(worst, err)
    log(f"[3 small] kernel vs twin, 8 cases: max-abs {worst:.3g} "
        f"(<= {TOL})")
    return worst


def _render_inputs(rig, device):
    import torch

    from surround360_tpu_torch.capture import render_camera_views

    views = render_camera_views(rig)
    side = np.stack([views[rig.ids.index(s)] for s in rig.side_ids])
    to_dev = lambda a: torch.from_numpy(a).to(device)
    return (to_dev(side), to_dev(views[rig.top_camera_index]),
            to_dev(views[rig.bottom_camera_index]))


def _preset_config(preset: str):
    from surround360_tpu_torch.cli.render_video import (
        PRESET_SHARPENING,
        PRESET_SIDE_FLOW_SCALE,
        QUALITY_PRESETS,
    )
    from surround360_tpu_torch.render.panorama import RenderConfig

    eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[preset]
    return RenderConfig(
        eqr_width=eqr_w, eqr_height=eqr_h, final_eqr_width=fin_w,
        final_eqr_height=fin_h, sharpening=PRESET_SHARPENING,
        side_flow_alg="pixflow_tpu", polar_flow_alg="pixflow_tpu",
        side_flow_scale=PRESET_SIDE_FLOW_SCALE.get(preset, 1.0),
        enable_top=True, enable_bottom=True,
    )


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_main_path(rig, preset, device):
    """Two chained frames through the user entry points; returns the
    context, inputs, outputs, launches and the recorded kernel calls."""
    import torch

    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.render.panorama import (
        build_render_context,
        render_frame,
    )

    t0 = time.perf_counter()
    inputs = _render_inputs(rig, device)
    ctx = build_render_context(rig, _preset_config(preset))
    log(f"[4 main] inputs + context in {time.perf_counter() - t0:.1f} s "
        f"(strip {ctx.strip_h}x{ctx.strip_w}, poles {ctx.top_h} rows)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fw.RECORD = {}
    fw.reset_launch_counts()
    times = []
    state = None
    for frame in range(2):
        t0 = time.perf_counter()
        out, state = render_frame(ctx, *inputs, state=state,
                                  use_temporal=frame > 0)
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches, sites = fw.LAUNCHES, dict(fw.SITE_LAUNCHES)
    record, fw.RECORD = fw.RECORD, None
    eqr = out["equirect"]
    cfg = ctx.config
    want = (3, cfg.final_eqr_height, cfg.final_eqr_width)
    if tuple(eqr.shape) != want:
        raise AssertionError(f"equirect {tuple(eqr.shape)} != {want}")
    if not bool(torch.isfinite(eqr).all()):
        raise AssertionError("non-finite values in the equirect")
    missing = [s for s in SITES if sites.get(s, 0) == 0]
    if missing and device.type == "cuda":
        raise AssertionError(f"no kernel launch at {missing}: {sites}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[4 main] {preset} {cfg.eqr_width}x{cfg.eqr_height}/eye -> "
        f"{tuple(eqr.shape)}: frame 0 {times[0]:.3f} s, frame 1 (temporal) "
        f"{times[1]:.3f} s, peak {peak:.2f} GiB, launches {launches} {sites}")
    return ctx, inputs, launches, record, times


def phase_sites(record):
    """Recorded main-path calls: kernel vs twin, and both times."""
    from surround360_tpu_torch.ops import fused_window as fw

    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for site in SITES:
        args, kw, got = record[site]
        want = fw.fused_window_sample_reference(*args, **kw)
        err = float((got - want).abs().max())
        if err > TOL:
            raise AssertionError(f"kernel vs twin at {site}: max-abs {err}")
        k_ms = cuda_ms(lambda: fw.fused_window_sample(*args, **kw))
        p_ms = cuda_ms(lambda: fw.fused_window_sample_reference(*args, **kw))
        T, L, P = args[3].shape
        log(f"[5 sites] {site}: T={T} L={L} C={args[0].shape[1]} P={P} "
            f"bh={kw['bh']} wx={kw['base_bw'] or kw['bw']} src="
            f"{tuple(args[0].shape)}: max-abs {err:.3g}, kernel "
            f"{k_ms:.3f} ms, twin {p_ms:.3f} ms")
        worst, ms, plain_ms = max(worst, err), ms + k_ms, plain_ms + p_ms
    return worst, ms, plain_ms


def phase_quality(ctx, inputs, device):
    """Full-sphere PSNR per eye, no sharpening and no final resize."""
    import dataclasses

    import torch

    from surround360_tpu_torch.capture import render_equirect_reference
    from surround360_tpu_torch.render.panorama import render_frame

    cfg = dataclasses.replace(
        ctx.config, sharpening=0.0, final_eqr_width=0, final_eqr_height=0
    )
    qctx = dataclasses.replace(ctx, config=cfg)
    eqr = render_frame(qctx, *inputs)[0]["equirect"]
    expect = torch.from_numpy(
        render_equirect_reference(qctx, full_sphere=True)
    ).to(device)
    h = cfg.eqr_height
    psnrs = []
    for eye in (eqr[:, :h], eqr[:, h:]):
        mse = float(torch.mean((eye - expect) ** 2))
        psnrs.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    log(f"[6 quality] full-sphere PSNR L {psnrs[0]:.2f} dB, R "
        f"{psnrs[1]:.2f} dB (>= {PSNR_MIN})")
    if min(psnrs) < PSNR_MIN:
        raise AssertionError(f"full-sphere PSNR {psnrs} below {PSNR_MIN}")
    return psnrs


def main():
    import torch

    smi = phase_device()
    phase_build()
    small_err = phase_small()
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    device = torch.device("cuda", 0)
    ctx, inputs, launches, record, _ = phase_main_path(
        make_ring_rig(), PRESET, device
    )
    site_err, ms, plain_ms = phase_sites(record)
    del record
    phase_quality(ctx, inputs, device)
    # ms / plain_ms: kernel and twin times summed over the recorded call
    # of each of the four call sites (phase 5)
    print(json.dumps({"kernels": [{
        "name": "fused_window_sample",
        "route": "cuda",
        "source": "surround360_tpu_torch/csrc/fused_window_sample.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(small_err, site_err),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
