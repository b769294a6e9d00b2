"""Smoke run of surround360_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the
kernels line; a phase-3 failure is printed at once and fails the run
after phase 9, so that the measurements still print):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off (the reference is float32).
2. build: builds every kernel source under surround360_tpu_torch/csrc/
   with nvcc, one process each, all started together, into
   surround360_tpu_torch/_build/; one line per source.
3. kernels vs twins at small shapes, max-abs <= 2e-5: K1 (every
   interpolation x border, tight and plain windows); K2 (the same modes
   with per-tile origins); K3 (the flow's offset sets at d = 8, 4, 2, 1,
   clamp and constant borders, one x tile and several); all with origins
   at the array edges, NaN and +-1e6 coordinates and a sample count that
   is no multiple of 32. Then the staged kernels' own paths: tap boxes
   far above a block's shared memory (the row-band walk), a (tile, lead)
   whose coordinates are all non-finite (an empty box), windows reaching
   past the array (boxes clipped at its edges) and 16 offsets.
4. main path: the 6k quality preset (6300x3072 per eye from 2048 px
   cameras, 6144x6144 final), pixflow_tpu flows, both poles merged,
   sharpening and the final resize; frame 0, then frame 1 chained through
   frame 0's temporal state. Requires the output shape, finite values and
   K1 launches at its four call sites and none of K2; prints seconds,
   peak memory and every kernel's launches.
5. main-path K1 vs twin: the recorded call of each call site (the one
   with the most samples), rerun through the plain PyTorch twin; max-abs
   <= 2e-5. Per call: launches per frame, kernel ms with a warm L2 and
   with a cold one (a 128 MiB write before each launch), twin ms, the
   yardstick (one torch.nn.functional.grid_sample call over the same
   samples, ms) and the bound: the larger of bytes / 3.35 TB/s and FLOPs
   / 67 TFLOP/s, the bytes counting the source pixels the taps read (see
   call_bounds).
6. quality: one more frame at the same geometry without sharpening or
   final resize; full-sphere PSNR per eye against the analytic reference
   must reach 40 dB.
7. cli: the simulator's views written as 16-bit PNGs (frame 1 hard-links
   frame 0), then the video CLI (render_video.main) at the 6k preset with
   pixflow_tpu_offsets on the ring and the poles, saving its state:
   requires K3 launches at both flow sites, none of K2, and finite
   6144x6144 frames; prints seconds per frame, the loop's host stages
   (PNG decode and encode, render, fetch), peak memory and every
   kernel's launches; then frame 1 again, resumed from frame 0's state
   pickle into another directory, within 1/255 of the chained frame 1.
8. flow sites: at each flow site, for each offset set (d = 8, 4, 2, 1),
   the recorded K3 call with the most samples (the finest pyramid level
   that ranks with that set) against the twin (max-abs <= 2e-5, and the
   numbers of phase 5); and K2 at the 6k side-flow level-0 geometry (the
   flow's 16-column tiles: tight-x, 13 folded candidates), a forced call
   that no launch count includes.
9. quality of a pixflow_tpu_offsets frame, as phase 6.

Then the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL = 2e-5  # kernel vs twin: same f32 tap math, FMA contraction differs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 128 * 2**20  # written before a cold call: > the 50 MB L2
SLEEP_CYCLES = 20_000_000  # ~10 ms queued ahead of timed calls
FRAMES = 2  # frames of each product path (phase 4 and phase 7)
PSNR_MIN = 40.0  # the reference package's preset-quality target
PRESET = "6k"
K1_SITES = ("side_projection", "novel_view", "fisheye_strip", "pole_warp")
FLOW_SITES = ("side_flow", "pole_flow")
PALLAS = "surround360_tpu/ops/pallas_remap.py"
REPLACES = {
    "fused_window_sample": f"{PALLAS}:640",
    "fused_window_folded": f"{PALLAS}:591 offsets=None",
    "fused_window_offsets": f"{PALLAS}:591 offsets",
}
SOURCES = {
    "fused_window_sample": "surround360_tpu_torch/csrc/fused_window_sample.cu",
    "fused_window_folded": "surround360_tpu_torch/csrc/fused_window_folded.cu",
    "fused_window_offsets": "surround360_tpu_torch/csrc/fused_window_folded.cu",
}
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_cli")  # gitignored; removed at the end


def log(msg: str) -> None:
    print(msg, flush=True)


_FLUSH = []


def cuda_ms(fn, reps: int = 5, cold: bool = False) -> float:
    """Device ms per call of ``fn``: CUDA events around each call, queued
    behind a ~10 ms sleep kernel so that the host's launch cost stays out
    of the time. ``cold``: a 128 MiB scratch write before each call
    evicts the L2, as the main path's large calls find it."""
    import torch

    fn()
    torch.cuda.synchronize()
    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES // 4, device="cuda"))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        if cold:
            _FLUSH[0].fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def flops_per_sample(interpolation: str, C: int, O: int = 1) -> int:
    """Hand count of one sample's float operations: both axes' tap weights
    once (bicubic: floor, fraction and 4 Keys weights of 5-7 operations,
    27 an axis; bilinear: floor, fraction, 1 - t, 3 an axis), then for
    each of the O fields and C channels one multiply-add (2 operations)
    per tap and one per tap row."""
    weights, ty, tx = (27, 4, 4) if interpolation == "bicubic" else (3, 2, 2)
    return 2 * weights + O * C * 2 * (ty * tx + ty)


def window_union_px(sy, sx, bh: int, wx: int, Hp: int, Wp: int):
    """Source pixels inside the union of the windows, clipped to the
    (Hp, Wp) array, per lead: sy, sx (T, L) origins give (L,) counts;
    per-tile (T,) origins, shared by every lead, give one count."""
    import torch

    sy = (sy[:, None] if sy.ndim == 1 else sy).long()
    sx = (sx[:, None] if sx.ndim == 1 else sx).long()
    T, L = sy.shape
    y0, y1 = sy.clamp(0, Hp), (sy + bh).clamp(0, Hp)
    x0, x1 = sx.clamp(0, Wp), (sx + wx).clamp(0, Wp)
    lead = torch.arange(L, device=sy.device).expand(T, L).flatten()
    diff = torch.zeros((L, Hp + 1, Wp + 1), dtype=torch.int32, device=sy.device)
    one = torch.ones(T * L, dtype=torch.int32, device=sy.device)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        diff.index_put_((lead, ys.flatten(), xs.flatten()), sign * one,
                        accumulate=True)
    cover = diff.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
    return (cover[:, :Hp, :Wp] > 0).sum(dim=(1, 2))


def touched_px(args, kw, tiles: int = 64) -> int:
    """Source pixels (summed over the leads) that the call's counted taps
    read with a nonzero weight, offsets included: the twin's tap geometry
    (window or interior test, borders, non-finite samples dropped) marked
    into one flag per pixel, ``tiles`` tiles at a time."""
    import torch

    from surround360_tpu_torch.ops.fused_window import axis_taps

    padded, sy, sx, xt, yt = args
    L, _, Hp, Wp = padded.shape
    T = xt.shape[0]
    offs = kw.get("offsets") or ((0, 0),)
    wx = kw["bw"] if (kw.get("base_bw") is None or kw.get("offsets")) else kw["base_bw"]
    my, mx = kw.get("off_my", 0), kw.get("off_mx", 0)
    cubic, clamp = kw["interpolation"] == "bicubic", kw["border"] == "clamp"
    seen = torch.zeros(L * Hp * Wp, dtype=torch.bool, device=xt.device)
    lead = torch.arange(L, device=xt.device)[None, :, None]
    for t0 in range(0, T, tiles):
        x, y = xt[t0:t0 + tiles], yt[t0:t0 + tiles]
        oy, ox = (o[t0:t0 + tiles] for o in (sy, sx))
        oy, ox = ((o[:, None] if o.ndim == 1 else o)[..., None] for o in (oy, ox))
        finite = torch.isfinite(x) & torch.isfinite(y)
        x, y = torch.where(finite, x, 0.0), torch.where(finite, y, 0.0)
        ty = axis_taps(y, oy + my, kw["bh"] - 2 * my, kw["pad_y"], kw["n_y"], cubic, clamp)
        tx = axis_taps(x, ox + mx, wx - 2 * mx, kw["pad_x"], kw["n_x"], cubic, clamp)
        for dy, dx in offs:
            for iy, wy in ty:
                iy = iy + dy
                for ix, wxx in tx:
                    ix = ix + dx
                    hit = (finite & (wy != 0) & (wxx != 0) & (iy >= 0) & (iy < Hp)
                           & (ix >= 0) & (ix < Wp))
                    seen[((lead * Hp + iy) * Wp + ix)[hit]] = True
    return int(seen.sum())


def call_bounds(args, kw) -> dict:
    """What one call must move and compute, and the least time an H100
    could take for it: the larger of bytes / 3.35 TB/s and FLOPs /
    67 TFLOP/s. Bytes: coordinates (8 B a sample), window origins (8 B a
    window) and outputs (4 B each) once, and the source pixels that the
    taps read (:func:`touched_px`) once. ``window_src_bytes``, beside it,
    is the source as the whole padded array or, where smaller, the union
    of the call's windows. FLOPs: :func:`flops_per_sample`."""
    padded, sy, sx, xt, _ = args
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    offs = kw.get("offsets")
    O = len(offs) if offs else 1
    wx = kw["bw"] if (kw.get("base_bw") is None or offs) else kw["base_bw"]
    union = window_union_px(sy, sx, kw["bh"], wx, Hp, Wp)
    union_px = int(union.sum()) if sy.ndim == 2 else int(union[0]) * L
    samples = T * L * P
    src_bytes = 4 * C * touched_px(args, kw)
    nbytes = 8 * samples + 8 * sy.numel() + 4 * samples * O * C + src_bytes
    flops = samples * flops_per_sample(kw["interpolation"], C, O)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=nbytes, flops=flops, src_bytes=src_bytes,
                window_src_bytes=4 * C * min(union_px, L * Hp * Wp),
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def library_call(args, kw):
    """The yardstick: ONE ``torch.nn.functional.grid_sample`` call over the
    same samples (the call's bicubic or bilinear, align_corners=True,
    zeros padding, coordinates normalised from padded pixels, the
    (T, L, P) samples as an (L, 1, T * P, 2) grid; K3's O offsets folded
    in as O x T x P points of coordinate + offset). It ignores the
    windows: it times the same work and is no parity check. Returns
    (call, to_twin_layout)."""
    import torch
    import torch.nn.functional as F

    padded, _, _, xt, yt = args
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    offs = kw.get("offsets")
    x = xt.permute(1, 0, 2).double()  # (L, T, P)
    y = yt.permute(1, 0, 2).double()
    if offs:
        o = torch.tensor(offs, dtype=torch.float64, device=xt.device)
        x = x[:, None] + o[None, :, 1, None, None]  # (L, O, T, P)
        y = y[:, None] + o[None, :, 0, None, None]
    grid = torch.stack([x * (2.0 / (Wp - 1)) - 1.0, y * (2.0 / (Hp - 1)) - 1.0], -1)
    grid = grid.float().reshape(L, 1, -1, 2).contiguous()

    def call():
        return F.grid_sample(padded, grid, mode=kw["interpolation"],
                             padding_mode="zeros", align_corners=True)

    def to_twin_layout(out):  # (L, C, 1, [O x] T x P) -> the twin's layout
        if offs:
            return out.reshape(L, C, len(offs), T, P).permute(3, 0, 2, 1, 4)
        return out.reshape(L, C, T, P).permute(2, 0, 1, 3)

    return call, to_twin_layout


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

    t0 = time.perf_counter()
    seconds = fw.build_all()
    for kernel in fw.KERNELS:
        fw._load_library(kernel)
    for source, secs in seconds.items():
        log(f"[2 build] {source}: nvcc {secs:.1f} s")
        for line in fw.ptxas_report(source):
            log(f"[2 build]   ptxas: {line}")
    log(f"[2 build] all sources in {time.perf_counter() - t0:.1f} s (parallel)")
    return seconds


def _edge_coords(rng, sy, sx, bh, wx, shape):
    """Coordinates around each window (+-5 px past it), with NaN and
    +-1e6 entries; sy, sx broadcast against shape[:-1]."""
    xt = sx[..., None] + rng.uniform(-5, wx + 5, shape)
    yt = sy[..., None] + rng.uniform(-5, bh + 5, shape)
    xt, yt = xt.astype(np.float32), yt.astype(np.float32)
    xt[2, :, :3] = [np.nan, 1e6, -1e6]
    yt[3, :, :3] = [-1e6, np.nan, 1e6]
    return xt, yt


def _small_cases(rng):
    """(kernel, name, arrays, kwargs) covering the borders, window modes,
    offset sets and edge cases of K1, K2 and K3."""
    L, C, Hp, Wp, T, P = 3, 4, 48, 300, 5, 77
    padded = rng.random((L, C, Hp, Wp), dtype=np.float32)
    base = dict(pad_y=4, pad_x=6, n_y=Hp - 8, n_x=Wp - 12)
    for interp in ("bicubic", "bilinear"):
        for border in ("constant", "clamp"):
            for tight in (False, True):
                bh = 24
                bw, base_bw = (256, 61) if tight else (128, None)
                wx = base_bw or bw
                kw = dict(base, bh=bh, bw=bw, interpolation=interp,
                          border=border, base_bw=base_bw)
                mode = f"{interp}/{border}/{'tight' if tight else 'plain'}"
                # K1: per-(tile, lead) origins
                sy = rng.integers(0, Hp - bh + 1, (T, L)).astype(np.int32)
                sx = rng.integers(0, Wp - wx + 1, (T, L)).astype(np.int32)
                sy[0], sx[0] = 0, 0  # origins at the array edges
                sy[1], sx[1] = Hp - bh, Wp - wx
                yield "fused_window_sample", mode, (
                    padded, sy, sx, *_edge_coords(rng, sy, sx, bh, wx, (T, L, P))), kw
                # K2: per-tile origins shared by the leads
                sy, sx = sy[:, 0].copy(), sx[:, 0].copy()
                yield "fused_window_folded", mode, (
                    padded, sy, sx,
                    *_edge_coords(rng, sy[:, None], sx[:, None], bh, wx, (T, L, P))), kw
    # K3: the flow's offset sets (centre, 4 neighbours, 4 diagonals at d),
    # bilinear; windows of the flow's shape (8 rows + margins, 128-aligned
    # columns), one x tile (every origin 0) or several
    C2, Wp2 = 2, 512
    padded2 = rng.random((L, C2, Hp + 16, Wp2), dtype=np.float32)
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
    for d in (8, 4, 2, 1):
        offs = ((0, 0),) + tuple((py * d, px * d) for py, px in dirs)
        for border in ("constant", "clamp"):
            for ntx in (1, 3):
                bh, bw = -(-(24 + 2 * d) // 8) * 8, 256
                sy = rng.integers(0, Hp + 16 - bh + 1, T).astype(np.int32)
                sx = (rng.integers(0, ntx, T) * 128).astype(np.int32)
                sy[0], sx[0] = 0, 0
                kw = dict(pad_y=4 + d, pad_x=6 + d, n_y=Hp, n_x=Wp2 - 40,
                          bh=bh, bw=bw, interpolation="bilinear",
                          border=border, offsets=offs, off_my=d, off_mx=d)
                yield "fused_window_offsets", f"d={d}/{border}/ntx={ntx}", (
                    padded2, sy, sx,
                    *_edge_coords(rng, sy[:, None], sx[:, None], bh, bw, (T, L, P))), kw
    yield from _edge_cases(rng)


def _edge_cases(rng):
    """(kernel, name, arrays, kwargs) for the staged kernels' own paths:
    tap boxes far above the shared-memory budget (the row-band walk), a
    (tile, lead) whose coordinates are all non-finite (an empty box),
    windows reaching past the array (boxes clipped at its edges), more
    samples than one block takes, and 16 offsets."""
    L, T, P = 2, 4, 3000
    Hp, Wp = 260, 340
    big = rng.random((L, 4, Hp, Wp), dtype=np.float32)
    base = dict(pad_y=3, pad_x=5, n_y=Hp - 6, n_x=Wp - 10)
    for interp, border in (("bicubic", "constant"), ("bicubic", "clamp"),
                           ("bilinear", "constant")):
        # 240 x 320 windows, taps all over them: a 1.2 MB box at C = 4
        kw = dict(base, bh=240, bw=320, interpolation=interp, border=border,
                  base_bw=None)
        sy = rng.integers(0, Hp - 240 + 1, (T, L)).astype(np.int32)
        sx = rng.integers(0, Wp - 320 + 1, (T, L)).astype(np.int32)
        xt, yt = _edge_coords(rng, sy, sx, 240, 320, (T, L, P))
        xt[1, 0] = np.nan  # every coordinate of (tile 1, lead 0)
        yield "fused_window_sample", f"edge/bands+empty/{interp}/{border}", (
            big, sy, sx, xt, yt), kw
        sy, sx = sy[:, 0].copy(), sx[:, 0].copy()
        xt, yt = _edge_coords(rng, sy[:, None], sx[:, None], 240, 320, (T, L, P))
        yt[1] = np.nan  # every coordinate of tile 1
        yield "fused_window_folded", f"edge/bands+empty/{interp}/{border}", (
            big, sy, sx, xt, yt), kw
        # 48 x 64 windows reaching past every edge of the array
        kw = dict(base, bh=48, bw=64, interpolation=interp, border=border,
                  base_bw=None)
        sy = np.array([[-20, Hp - 30], [-5, 100], [Hp - 10, -40], [7, Hp - 48]],
                      np.int32)
        sx = np.array([[-30, Wp - 20], [Wp - 60, -10], [-50, 90], [Wp - 64, 3]],
                      np.int32)
        yield "fused_window_sample", f"edge/clipped/{interp}/{border}", (
            big, sy, sx, *_edge_coords(rng, sy, sx, 48, 64, (T, L, 517))), kw
        sy, sx = sy[:, 0].copy(), sx[:, 0].copy()
        yield "fused_window_folded", f"edge/clipped/{interp}/{border}", (
            big, sy, sx,
            *_edge_coords(rng, sy[:, None], sx[:, None], 48, 64, (T, L, 517))), kw
    src2 = rng.random((L, 2, Hp, Wp), dtype=np.float32)
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
    nine = ((0, 0),) + tuple((py * 8, px * 8) for py, px in dirs)
    sixteen = ((0, 0),) + dirs + tuple((py * 2, px * 2) for py, px in dirs[:7])
    for border in ("constant", "clamp"):
        kw = dict(pad_y=9, pad_x=9, n_y=Hp - 18, n_x=Wp - 18, bh=200, bw=256,
                  interpolation="bilinear", border=border, offsets=nine,
                  off_my=8, off_mx=8)
        sy = rng.integers(0, Hp - 200 + 1, T).astype(np.int32)
        sx = np.array([0, 0, 0, 0], np.int32)
        xt, yt = _edge_coords(rng, sy[:, None], sx[:, None], 200, 256, (T, L, P))
        xt[1] = np.nan
        yield "fused_window_offsets", f"edge/bands+empty/d=8/{border}", (
            src2, sy, sx, xt, yt), kw
        kw = dict(kw, bh=40, bw=128, offsets=sixteen, off_my=2, off_mx=2)
        sy = np.array([-12, Hp - 25, 100, Hp - 40], np.int32)
        sx = np.array([0, 256, 128, 256], np.int32)  # 256 + 128 > Wp
        yield "fused_window_offsets", f"edge/clipped/O=16/{border}", (
            src2, sy, sx,
            *_edge_coords(rng, sy[:, None], sx[:, None], 40, 128, (T, L, 700))), kw


def _twin_call(kernel):
    from surround360_tpu_torch.ops import fused_window as fw

    if kernel == "fused_window_sample":
        return fw.fused_window_sample, fw.fused_window_sample_reference
    return fw.fused_window_sample_folded, fw.fused_window_sample_folded_reference


def phase_small():
    """Every small case, kernel vs twin. Returns (worst max-abs per kernel,
    the failed cases); a failure is printed here and fails the run at its
    end, so that the later phases still measure."""
    import torch

    worst: dict = {}
    failed = []
    rng = np.random.default_rng(0)
    for kernel, name, arrays, kw in _small_cases(rng):
        call, twin = _twin_call(kernel)
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        got = call(*dev, **kw)
        torch.cuda.synchronize()
        want = twin(*dev, **kw)
        err = float((got - want).abs().max())
        bad = not torch.isfinite(got).all() or err > TOL
        if bad:
            failed.append(f"{kernel} vs twin {name}: max-abs {err}")
            log(f"[3 small] FAILED {failed[-1]}")
        n, n_bad, w = worst.get(kernel, (0, 0, 0.0))
        worst[kernel] = (n + 1, n_bad + bad, max(w, err))
    for kernel, (n, n_bad, err) in worst.items():
        log(f"[3 small] {kernel} vs twin, {n} cases: max-abs {err:.3g} "
            + (f"({n_bad} FAILED)" if n_bad else f"(<= {TOL})"))
    return {k: v[2] for k, v in worst.items()}, failed


def _render_inputs(rig, device):
    import torch

    from surround360_tpu_torch.capture import render_camera_views

    views = render_camera_views(rig)
    side = np.stack([views[rig.ids.index(s)] for s in rig.side_ids])
    to_dev = lambda a: torch.from_numpy(a).to(device)
    inputs = (to_dev(side), to_dev(views[rig.top_camera_index]),
              to_dev(views[rig.bottom_camera_index]))
    return inputs, views


def _preset_config(preset: str, flow_alg: str = "pixflow_tpu"):
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
        side_flow_alg=flow_alg, polar_flow_alg=flow_alg,
        side_flow_scale=PRESET_SIDE_FLOW_SCALE.get(preset, 1.0),
        enable_top=True, enable_bottom=True,
    )


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_main_path(rig, preset, device):
    """Two chained frames through the user entry points; returns the
    context, inputs, views, launches per kernel, the recorded calls and
    times."""
    import torch

    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.render.panorama import (
        build_render_context,
        render_frame,
    )

    t0 = time.perf_counter()
    inputs, views = _render_inputs(rig, device)
    t1 = time.perf_counter()
    ctx = build_render_context(rig, _preset_config(preset))
    log(f"[4 main] simulator views {t1 - t0:.1f} s, build_render_context "
        f"{time.perf_counter() - t1:.1f} s (strip {ctx.strip_h}x"
        f"{ctx.strip_w}, poles {ctx.top_h} rows)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fw.RECORD = {}
    times = []
    state = None
    fw.reset_launch_counts()
    for frame in range(FRAMES):
        t0 = time.perf_counter()
        out, state = render_frame(ctx, *inputs, state=state,
                                  use_temporal=frame > 0)
        _sync(device)
        times.append(time.perf_counter() - t0)
    sites = {s: fw.launch_count(fw.K1, s) for s in K1_SITES}
    launches = {k: fw.launch_count(k) for k in fw.KERNELS}
    record, fw.RECORD = fw.RECORD, None
    eqr = out["equirect"]
    cfg = ctx.config
    want = (3, cfg.final_eqr_height, cfg.final_eqr_width)
    if tuple(eqr.shape) != want:
        raise AssertionError(f"equirect {tuple(eqr.shape)} != {want}")
    if not bool(torch.isfinite(eqr).all()):
        raise AssertionError("non-finite values in the equirect")
    missing = [s for s, n in sites.items() if n == 0]
    if missing and device.type == "cuda":
        raise AssertionError(f"no kernel launch at {missing}: {sites}")
    if launches[fw.K2]:
        raise AssertionError(f"K2 launched on the product path: {launches}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[4 main] {preset} {cfg.eqr_width}x{cfg.eqr_height}/eye -> "
        f"{tuple(eqr.shape)}: frame 0 {times[0]:.3f} s, frame 1 (temporal) "
        f"{times[1]:.3f} s, peak {peak:.2f} GiB, K1 sites {sites}, launches "
        f"{launches}")
    return ctx, inputs, views, launches, record, times


def _site_check(phase, key, record, per_frame):
    """Recorded call vs twin, and its times: the kernel warm and with a
    cold L2, the twin, the grid_sample yardstick, beside the call's bound.
    Returns the site's entry of the kernels line."""
    kernel, site, _ = key
    args, kw, got = record[key][:3]
    call, twin = _twin_call(kernel)
    want = twin(*args, **kw)
    err = float((got - want).abs().max())
    del want
    if err > TOL:
        raise AssertionError(f"{kernel} vs twin at {site}: max-abs {err}")
    library, _ = library_call(args, kw)
    r = dict(site=site, launches_per_frame=per_frame, max_abs_err=err,
             ms=cuda_ms(lambda: call(*args, **kw)),
             cold_ms=cuda_ms(lambda: call(*args, **kw), cold=True),
             plain_ms=cuda_ms(lambda: twin(*args, **kw)),
             library_ms=cuda_ms(library), **call_bounds(args, kw))
    T, L, P = args[3].shape
    wx = kw["base_bw"] or kw["bw"]
    offs = kw.get("offsets")
    shape = (f"O={len(offs)} d={kw['off_my']} ntx={len(args[2].unique())}"
             if offs else "O=1")
    r["shape"] = (f"T={T} L={L} C={args[0].shape[1]} P={P} {shape} "
                  f"bh={kw['bh']} wx={wx} src={tuple(args[0].shape)} "
                  f"{kw['interpolation']}/{kw['border']}")
    log(f"[{phase}] {kernel} at {site}: {r['shape']}: {per_frame:g} "
        f"launches/frame, max-abs {err:.3g}, kernel {r['ms']:.4f} ms (cold L2 "
        f"{r['cold_ms']:.4f}), twin {r['plain_ms']:.3f} ms, grid_sample "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']} ({r['bytes'] / 1e6:.1f} MB with {r['src_bytes'] / 1e6:.1f} "
        f"MB of source taps, {r['window_src_bytes'] / 1e6:.1f} MB in the windows; "
        f"{r['flops'] / 1e9:.2f} GFLOP), "
        f"{r['bound_ms'] / r['ms']:.0%} of bound")
    return r


def phase_sites(record):
    """Recorded main-path K1 calls (one per site): kernel vs twin, times,
    yardstick and bound, and the site's launches per frame."""
    keys = [("fused_window_sample", site, None) for site in K1_SITES]
    return [_site_check("5 sites", k, record, record[k][3] / FRAMES) for k in keys]


def _psnr_full_sphere(qctx, inputs, expect):
    from surround360_tpu_torch.render.panorama import render_frame

    eqr = render_frame(qctx, *inputs)[0]["equirect"]
    import torch

    h = qctx.config.eqr_height
    psnrs = []
    for eye in (eqr[:, :h], eqr[:, h:]):
        mse = float(torch.mean((eye - expect) ** 2))
        psnrs.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    return psnrs


def phase_quality(ctx, inputs, device, flow_alg, phase, expect=None):
    """Full-sphere PSNR per eye, no sharpening and no final resize."""
    import torch

    from surround360_tpu_torch.capture import render_equirect_reference

    cfg = dataclasses.replace(
        ctx.config, sharpening=0.0, final_eqr_width=0, final_eqr_height=0,
        side_flow_alg=flow_alg, polar_flow_alg=flow_alg,
    )
    qctx = dataclasses.replace(ctx, config=cfg)
    if expect is None:
        expect = torch.from_numpy(
            render_equirect_reference(qctx, full_sphere=True)
        ).to(device)
    psnrs = _psnr_full_sphere(qctx, inputs, expect)
    log(f"[{phase}] {flow_alg}: full-sphere PSNR L {psnrs[0]:.2f} dB, R "
        f"{psnrs[1]:.2f} dB (>= {PSNR_MIN})")
    if min(psnrs) < PSNR_MIN:
        raise AssertionError(f"full-sphere PSNR {psnrs} below {PSNR_MIN}")
    return expect


def _write_footage(rig, views, imgs):
    """Frame 0 as 16-bit PNGs with the port's writer; frame 1 hard-links
    frame 0."""
    from surround360_tpu_torch.cli.common import write_image
    from surround360_tpu_torch.geometry.rig import save_rig

    os.makedirs(imgs, exist_ok=True)
    rig_path = os.path.join(WORK, "rig.json")
    save_rig(rig_path, rig)

    def one(i):
        d = os.path.join(imgs, rig.ids[i])
        os.makedirs(d, exist_ok=True)
        write_image(os.path.join(d, "000000.png"), views[i], bit_depth=16)
        os.link(os.path.join(d, "000000.png"), os.path.join(d, "000001.png"))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(len(rig.ids))))
    return rig_path


def _video(argv):
    """render_video.main; returns its state, wall seconds, the loop's
    stage totals and the peak memory."""
    import torch

    from surround360_tpu_torch.cli import render_video
    from surround360_tpu_torch.cli.common import StageTimer

    timer = StageTimer()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = render_video.main(argv, timer=timer)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    return state, wall, timer.totals(), peak


def phase_cli(rig, views):
    """The video CLI at 6k with pixflow_tpu_offsets, chained and resumed.
    Returns the launches per kernel and the recorded K3 calls."""
    import torch

    from surround360_tpu_torch.cli.common import read_image_rgba
    from surround360_tpu_torch.cli.render_video import QUALITY_PRESETS
    from surround360_tpu_torch.ops import fused_window as fw

    shutil.rmtree(WORK, ignore_errors=True)
    imgs = os.path.join(WORK, "imgs")
    t0 = time.perf_counter()
    rig_path = _write_footage(rig, views, imgs)
    log(f"[7 cli] {len(rig.ids)} cameras x 2 frames as 16-bit PNGs in "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--rig_json_file", rig_path, "--imgs_dir", imgs, "--quality",
              PRESET, "--enable_top", "--enable_bottom",
              "--side_flow_alg", "pixflow_tpu_offsets",
              "--polar_flow_alg", "pixflow_tpu_offsets"]
    chained = os.path.join(WORK, "chained")
    states = os.path.join(WORK, "state")
    fw.RECORD = {}
    fw.reset_launch_counts()
    state, wall, stages, peak = _video(
        common + ["--output_dir", chained, "--start_frame", "0",
                  "--end_frame", "1", "--save_state_dir", states])
    sites = {s: fw.launch_count(fw.K3, s) for s in FLOW_SITES}
    launches = {k: fw.launch_count(k) for k in fw.KERNELS}
    record, fw.RECORD = fw.RECORD, None
    if any(n == 0 for n in sites.values()):
        raise AssertionError(f"K3 not launched at every flow site: {sites}")
    if launches[fw.K2]:
        raise AssertionError(f"K2 launched on the product path: {launches}")
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        raise AssertionError("non-finite temporal state")
    frames = [read_image_rgba(os.path.join(chained, "eqr_frames", f"eqr_{f:06d}.png"))
              for f in (0, 1)]
    _, _, fin_w, fin_h = QUALITY_PRESETS[PRESET]
    for img in frames:
        if img.shape != (4, fin_h, fin_w) or not np.isfinite(img).all():
            raise AssertionError(f"bad output frame {img.shape}")
    loop_s = stages["loop"][1]
    log(f"[7 cli] render_video {PRESET} pixflow_tpu_offsets, 2 frames: "
        f"{loop_s / 2:.3f} s/frame ({loop_s:.3f} s loop, {wall:.1f} s with "
        f"context), peak {peak:.2f} GiB, K3 sites {sites}, launches {launches}")
    log("[7 cli] loop stages, seconds summed (entries): " + ", ".join(
        f"{name} {secs:.3f} ({n})" for name, (n, secs) in stages.items()))

    resumed = os.path.join(WORK, "resumed")
    _, wall, _, _ = _video(
        common + ["--output_dir", resumed, "--start_frame", "1",
                  "--end_frame", "1", "--resume_state",
                  os.path.join(states, "state_000000.pkl")])
    again = read_image_rgba(os.path.join(resumed, "eqr_frames", "eqr_000001.png"))
    err = float(np.abs(again - frames[1]).max())
    log(f"[7 cli] frame 1 resumed from state_000000.pkl ({wall:.1f} s with "
        f"context and IO): max-abs vs chained {err:.3g} (<= 1/255)")
    if err > 1.0 / 255.0 + 1e-6:
        raise AssertionError(f"resumed frame 1 differs by {err}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, record


def phase_flow_sites(record, device):
    """K3 at each flow site and offset set (recorded in phase 7), and K2 at
    the 6k side-flow level-0 geometry."""
    import torch

    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.ops.window_sampler import make_window_sampler

    d = lambda offs: max(abs(v) for o in offs for v in o)
    keys = sorted((k for k in record if k[0] == fw.K3),
                  key=lambda k: (k[1], -d(k[2])))  # by site, then d
    if {k[1] for k in keys} != set(FLOW_SITES):
        raise AssertionError(f"K3 records at {keys}, want {FLOW_SITES}")
    k3 = [_site_check("8 flow sites", k, record, record[k][3] / FRAMES)
          for k in keys]
    # the side flow's level 0 at 6k: 14 pairs, 331x227, halos 39 / 56,
    # the flow's 16-column tiles (tight-x), 13 folded candidates
    g = torch.Generator(device=device).manual_seed(0)
    B, H, W, hy, hx, E = 14, 331, 227, 39, 56, 13
    img = torch.rand((B, 2, H, W), generator=g, device=device)
    gy, gx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    noise = lambda h: (torch.rand((E, B, H, W), generator=g, device=device) * 2 - 1) * h
    xs, ys = gx + noise(1.5 * hx), gy + noise(1.5 * hy)
    fn = make_window_sampler(img, (H, W), hy, hx, "bilinear", "clamp", tr=8,
                             tc=16, backend="kernel", site="side_flow_level0")
    if fn.backend != "kernel":
        raise AssertionError("the 6k side-flow level 0 is off the fused route")
    fw.RECORD = {}
    fn(xs, ys)
    rec, fw.RECORD = fw.RECORD, None
    k2 = _site_check("8 flow sites", (fw.K2, "side_flow_level0", None), rec, 0)
    return k3, k2


def _kernel_entry(name, launches, small_err, sites, nvcc_s):
    """One kernel of the kernels line: times summed over its recorded
    calls (``sites``), each of which is listed with its own numbers."""
    total = lambda k: sum(r[k] for r in sites)
    bytes_ms = sum(r["bytes"] for r in sites) / HBM_BYTES_PER_S * 1e3
    flops_ms = sum(r["flops"] for r in sites) / F32_FLOPS_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max([small_err] + [r["max_abs_err"] for r in sites]),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": total("library_ms"),
        "cold_ms": total("cold_ms"),
        "nvcc_s": nvcc_s[os.path.basename(SOURCES[name])],
        "sites": sites,
    }


def main():
    import torch

    smi = phase_device()
    nvcc_s = phase_build()
    small, small_failed = phase_small()
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    device = torch.device("cuda", 0)
    rig = make_ring_rig()
    ctx, inputs, views, render_launches, record, _ = phase_main_path(
        rig, PRESET, device)
    k1 = phase_sites(record)
    del record
    expect = phase_quality(ctx, inputs, device, "pixflow_tpu", "6 quality")
    cli_launches, record = phase_cli(rig, views)
    del views
    k3, k2 = phase_flow_sites(record, device)
    del record
    phase_quality(ctx, inputs, device, "pixflow_tpu_offsets", "9 quality", expect)
    if small_failed:
        raise AssertionError(f"phase 3 failed: {small_failed}")
    # ms, cold_ms, plain_ms, library_ms, bound_ms: summed over the recorded
    # calls (K1: the largest per call site, phase 5; K3: the largest per
    # flow site and offset set, phase 8; K2: its forced call in phase 8).
    # launches: the two product paths' runs (phase 4's render_frame and
    # phase 7's CLI), counted from 0 just before each; K2 has no product
    # caller, so 0
    launches = {k: render_launches[k] + cli_launches[k] for k in render_launches}
    entries = [
        _kernel_entry(name, launches[name], small[name], sites, nvcc_s)
        for name, sites in (("fused_window_sample", k1),
                            ("fused_window_folded", [k2]),
                            ("fused_window_offsets", k3))
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
