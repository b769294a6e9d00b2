"""Smoke run of surround360_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, 9 to 15 minutes
    python3 chip_smoke.py --quick    # phases 1-3, the probes against their
                                     # twins and the product path's kernel
                                     # sites on random inputs, ~40 s

Phases (each prints its lines; any failure exits non-zero before the
kernels line; a phase-3 or phase-14 mismatch is printed at once and fails
the run after phase 13, so that the measurements still print). Phases 14,
15 and 22 run after phase 9, while phase 4's context is alive:

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
   past the array (boxes clipped at its edges), 16 offsets, and C = 3
   sources under windows as wide as a padded 6k and 8k panorama row (one
   row fills most of a block's shared memory); a window row that no
   block can hold must raise from the wrapper.
4. main path: the 6k quality preset (6300x3072 per eye from 2048 px
   cameras, 6144x6144 final), pixflow_tpu flows, both poles merged,
   sharpening and the final resize; frame 0, then frame 1 chained through
   frame 0's temporal state, with the per-call record open (phase 5's
   calls; the flow's levels then run eagerly). Then the same chain for 3
   frames with no record open, as users run it: the flow's pyramid levels
   run as CUDA graphs (frames 0-1 capture, frame 2 replays; no level
   eager), and the replayed frame launches per (kernel, site) what the
   recorded frame 1 launched. Requires the output shape, finite values
   and K1 launches at its four call sites and none of K2; prints seconds
   a frame, peak memory and every kernel's launches of the graphed run.
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
7. cli: the simulator's views written as 16-bit PNGs (frames 1 and 2
   hard-link frame 0), then the video CLI (render_video.main) at the 6k
   preset with pixflow_tpu_offsets on the ring and the poles, frames 0-1
   with the per-call record open (phase 8's calls; the levels run
   eagerly), saving its state: requires none of K2 and finite 6144x6144
   frames; prints seconds per frame, the loop's host stages (PNG decode
   and encode, render, fetch) and peak memory. Then frames 0-2 with no
   record open: every flow level graphed, K3's too (frames 0-1 capture,
   frame 2 replays); requires K3 launches at both flow sites in the
   replayed frame, its launches per (kernel, site) equal to the recorded
   frame 1's, and frames 0-1 equal to the recorded ones (max-abs 0);
   prints its seconds per frame and every kernel's launches. Last, frame
   1 again, resumed from frame 0's state pickle into another directory,
   within 1/255 of the chained frame 1.
8. flow sites: at each flow site, for each offset set (d = 8, 4, 2, 1),
   the recorded K3 call with the most samples (the finest pyramid level
   that ranks with that set) against the twin (max-abs <= 2e-5, and the
   numbers of phase 5); and K2 at the 6k side-flow level-0 geometry (the
   flow's 16-column tiles: tight-x, 13 folded candidates), a forced call
   that no launch count includes.
9. quality of a pixflow_tpu_offsets frame, as phase 6.
10. unpack: raw footage made on the host from the simulator's views (a
   pole painted into both bottom cameras; each view sent backwards
   through a non-trivial ISP config, mosaiced, packed to 12 bits; 17
   cameras x 2 frames in one .bin, per-serial ISP JSONs), then the
   unpack CLI (unpack.main) on the card, writing 16-bit PNGs. Requires
   17 x 2 frames, every frame's interior near the simulator's view, the
   ISP on the card near the ISP on the CPU for one camera, and the native
   converters equal to the numpy ones; prints ISP ms per frame and
   camera, unpack seconds per frame and its host stages.
11. product cli: render_video.main on phase 10's PNGs at the 6k preset
   with pole removal (red masks over the painted pole), a 1536 px
   cubemap and pixflow_tpu_offsets on the ring, the poles and the pole
   removal; two chained frames, then frame 1 resumed from frame 0's
   pickle: equirect and cubemap equal to the chained frame (max-abs 0).
   The two chained frames run with the per-call record open (phase 12's
   calls), then again with none: no flow level eager there. Requires,
   of the run with no record, the cubemap's shape, K1 launches at the
   cubemap's two remaps and the pole-removal warp, K3 launches at the
   pole-removal flow, and (pole removal rerun on the same PNGs) alpha
   refilled under the primary mask and the mask's interior near the
   unpainted view.
12. new sites: the recorded calls of phase 11's new kernel sites, as
   phases 5 and 8.
13. debug and profile: one frame at the preview preset with
   --save_debug_images --profile_stages (the debug tree's files, the
   stage table), then run_all.main --steps unpack,render at the preview
   preset on a small footage (256 px cameras): runtimes.txt and frames.
14. probes: every K4 (kernel_step_cost: dots_x5, tent_plus_dots_x5,
   tent_dots_roll_x5, lead8_fori, lead8_unrolled, tent_dots_dyn_dma_x5)
   and K5 (kernel_body_cost: full, no_ohx, no_ohy, no_dot, no_reduce,
   no_roll, full_dma) variant against its twin at the smaller grid that
   its probe's main() times (64 steps for K4, 256 for K5; K4 within
   1e-5 of the output's max |value|, K5 within 2e-5 of max(1, that)); then
   the two probes' main() as a user runs them (launches counted from 0;
   every probe site must launch), each variant's us per grid step by the
   reference's grid contrast, its bound (probe_bound: the products at the
   tensor-core rate of their precision, K4 3xTF32, K5 3-pass bf16) and
   share, the SIMT bound (every FLOP at 67 TFLOP/s) and share, the twin's
   us per step and one batched torch.matmul of the variant's own matrices
   (the yardstick). Before the check against the twins, each probe
   kernel's registers and spills (ptxas) and its HMMA instructions
   (cuobjdump -sass); a kernel with a product and no HMMA fails the run.
15. harnesses: preset_table at the 6k preset, temporal, 3 chained frames
   (ms per frame, median, peak memory); preset_quality at 3k, 2 chained
   frames, >= 40 dB full sphere; profile_stages at its defaults;
   flow_quality (pixflow_tpu under tests/test_flow_quality.py's
   thresholds); trace_grid_economics on phase 4's 6k context. Every
   harness runs through its entry point; any failure row fails the run.
16. capture: the capture daemon (capture/daemon.py over two native rings)
   records phase 10's 17 packed 12-bit 2048x2048 payloads for 8 frames
   into two .bin files (cameras round-robin), one camera skipping a frame
   counter; requires 1 drop counted and every frame read back byte-equal
   through BinaryFootageReader; prints frames/s and GB/s of the record.
17. preview: the preview CLI (cli/preview.main) on those files, on the
   card, at 1024x512 (every frame) and 4096x2048 (two frames): the
   renderer's ms a frame (CUDA events around PreviewRenderer.render),
   the JPEG encode's ms, the loop's frames/s and the peak memory; frame 0
   on the card within 1e-4 of the CPU's, the top pole within 0.1 mean abs
   of the simulator's environment (the bottom pole is painted); then the
   CLI on the CPU at 1024x512 for phase 18. The .bin files are removed.
18. compare: cli/compare.main on phase 17's JPEGs, the card's directory
   against itself (> 100 dB) and against the CPU's with --min_psnr_db 40.
19. geometric calibration on the 17-camera 2048 px ring (no hand kernel on
   this path; the sampler and probe counts are reset before phase 19 and
   must read 0 after phase 20): (a) calibrate geometric --unit_test at
   20000 points (~60 000 observations), 10 passes, 0.01 rad: refined RMSE
   < 0.15 x the perturbed rig's, every forward dot > 0.99999
   (tests/test_calib_geometric.py); observations, seconds a pass and an LM
   iteration, peak memory. (b) the library at 2000 points, 0.5 px noise, 3
   passes on the card and the CPU: rows within 1e-6 rad and 1e-4 px, RMSE
   in 0.2-1.5 px. (c) the matcher, OpenCV's ORB stage for stage: the 17
   simulator views of a corner-rich scene (calibration_environment:
   tests/test_matches.py's sinusoid scene gives ORB next to no keypoints
   at 2048 px; the count is printed); detect_and_compute on the card equal
   to the CPU's bit for bit (positions, descriptors, levels) on two of
   those views; match_frames over every pair with overlap >= 0.05 (ms a
   pair beside the learned-table matcher's), the traces through the
   library with tests/test_matches.py's config (median < 0.7 x, forward
   dots > 0.999);
   then the reference's own loop (tests/test_matches.py: the 6-camera ring
   at 512 px under the sinusoid scene, ring pairs matched on the card,
   detect_and_compute card = CPU on its six views, the library on the
   card: traces > 30, median < 0.7 x, min forward dot > 0.999); the
   keypoints and matches written to a COLMAP-schema database, converted by
   colmap_db_to_matches_json, and the CLI's --matches_json and
   --frames_dir routes each within 1e-9 of the library on that route's own
   positions and each under the loop's median gate on its own traces; the
   JSON route's positions (each float32 read back through its shortest
   decimal string) within one float32 ulp at 2048 px of the frames
   route's; the two refined rigs' differences printed.
20. vignetting: 100 frames of 2048x2048 16-bit PNG (a grey square on a
   10x10 grid under a known separable Bezier rolloff, with noise); the
   library on the card and the CPU (acquisition ms a frame, fit seconds;
   locations within 1 px of the targets, gain x surface flat within 1%),
   then calibrate vignetting on both: ISP JSON rolloff equal within 1e-6.
21. color: 17 MacBeth charts of 2048x2048 as 16-bit PNGs, rendered on the
   host without OpenCV (render_chart: tests/test_calib_color.py's chart at
   1.5x its geometry, each camera its own rotation in -7..7 degrees,
   perspective up to 0.04, the vignette, noise 0.01), their colours raw as
   TestColorSolve makes them (a known black level, colour matrix and
   falloff). The library on the card and the CPU: detection ms a camera
   (pixel stages, components, contours), solve seconds; 24 patches within
   5 px of the truth, black level within 0.02, WB x CCM grey to grey within
   0.02, the corrected medians' mean DeltaE. Then calibrate color on both:
   seconds, the card's ISP JSONs equal to the CPU's within 1e-9; peak
   memory; one chart at 1.0x (where the reference also returns the chart's
   outline): 24 patches and a solve. Phases 19-21 launch no kernel.
23. bench and root entries (after phase 21): python -m
   surround360_tpu_torch.bench as a user runs it, in a subprocess with
   S360_BENCH_MEMSTATS=1, (a) at its defaults (the 6k preset, 3 temporal
   frames timed with one sync) and (b) in its legacy mode (1008x504, 512
   px cameras, batch 8 chained, 2 batches): exit 0, the last line's four
   keys, value > 0; frames/s, seconds a frame, peak memory, the
   subprocess's wall seconds and its kernel launches (K1 must launch);
   (c) graft_entry.entry() on the card (shape, finite) and
   dryrun_multichip(8) on the card repeated (its line, both meshes within
   1e-4 of the chain); (d) TF32: calibrate vignetting in a fresh process
   that sets no TF32 flag, on phase 20's sweep, equal to phase 20's card
   JSON within 1e-6; then a 2048 px 16-bit raw written as TIFF by the
   port's writer through raw2rgb on the card, equal to the PNG route.
22. mesh (run right after phase 15, on phase 4's 6k context and inputs):
   parallel/mesh.py's sharded_render_step, temporal, on make_render_mesh()
   over the visible cards (2 frames), on the card repeated 14 times at
   (data 2, ring 7) (4 frames, two steps chained through the returned
   states) and at (data 1, ring 14) (2 frames); every frame within 1e-4 of
   a sequential render_frame chain (each data shard's chain continued by
   the second step); s a frame of each mesh and of the chain, peak memory,
   K1 and K3 launches of each mesh run (K1 must launch). One card: no
   multi-GPU rate is measured.

Then the kernels' JSON line (K1-K3 and the four probe sites; K1's launches
include phase 23's), the card's
name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import io
import json
import re
import sqlite3
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

from s360bench.bounds import HBM_BYTES_PER_S, call_bytes, touched_px

TOL = 2e-5  # kernel vs twin: same f32 tap math, FMA contraction differs
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense (NVIDIA data sheet)
FLUSH_BYTES = 128 * 2**20  # written before a cold call: > the 50 MB L2
SLEEP_CYCLES = 20_000_000  # ~10 ms queued ahead of timed calls
FRAMES = 2  # frames of each product path (phase 4 and phase 7)
GRAPHED_FRAMES = 3  # with no record open: frames 0-1 capture the flow's levels, 2 replays
PSNR_MIN = 40.0  # the reference package's preset-quality target
PRESET = "6k"
K1_SITES = ("side_projection", "novel_view", "fisheye_strip", "pole_warp")
FLOW_SITES = ("side_flow", "pole_flow")
# the product path with pole removal and a cubemap adds these
K1_PRODUCT_SITES = ("cubemap_eq", "cubemap_po", "pole_removal_warp")
POLE_REMOVAL_FLOW = "pole_removal_flow"
CUBE = 1536  # cubemap face, px
FLOW_ALG = "pixflow_tpu_offsets"
ISP_MEAN_ERR = 0.01  # unpacked frame vs the simulator's view, interior mean
ISP_STEP_MAX = 0.05  # ISP on the card vs the CPU: a tone-LUT entry near black, sharpened
ISP_FLIPS_MAX = 0.005  # share of values whose LUT index may flip
POLE_PSNR_MIN = 40.0  # mask interior vs the unpainted view, dB
CAPTURE_FRAMES = 8  # frames the capture daemon records (phase 16)
CAPTURE_GAP = (5, 4)  # (camera, frame): that camera's counter skips one there
PREVIEW_SIZES = ((1024, 512, 0), (4096, 2048, 2))  # (w, h, frames; 0: all)
PREVIEW_MAX_ERR = 1e-4  # the card's preview frame vs the CPU's, max-abs
POLE_ENV_ERR = 0.1  # top pole vs the environment, mean abs (tests/test_preview_dng.py)
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
# the benchmark folder's kernel probes (K4, K5): kernel site -> the TPU
# kernel it replaces and its source; K4 is held within 1e-5 of the
# output's max |value|, K5 within 2e-5 of max(1, that)
PROBE_REPLACES = {
    "kernel_step_cost_variant": "benchmarks/kernel_step_cost.py:121",
    "kernel_step_cost_dyn": "benchmarks/kernel_step_cost.py:217",
    "kernel_step_cost_dma": "benchmarks/kernel_step_cost.py:284",
    "kernel_body_cost": "benchmarks/kernel_body_cost.py:176",
}
PROBE_SOURCES = {
    site: "surround360_tpu_torch/csrc/" + ("kernel_body_cost.cu" if site == "kernel_body_cost"
                                           else "kernel_step_cost.cu")
    for site in PROBE_REPLACES
}
K4_REL, K5_REL = 1e-5, 2e-5
LIBRARY_STEPS = 64  # steps of the batched torch.matmul yardstick
# pixflow_tpu midpoint RMSE: scene -> (max, improvement over no flow), as
# tests/test_flow_quality.py holds the JAX package
FLOW_THRESHOLDS = {"translation": (0.006, 4.0), "rotation": (0.007, 2.0),
                   "zoom": (0.006, 2.0), "shear": (0.0025, 1.5), "occlusion": (0.022, 1.3)}
QUALITY_PRESET = "3k"  # phase 15's preset_quality (phases 6 and 9 cover 6k)
# phase 19: geometric calibration on the 17-camera 2048 px ring
CALIB_POINTS = 20000  # (a) the CLI's --unit_test: ~60 000 observations
CALIB_PASSES = 10
CALIB_PERTURB = 0.01  # rad
NOISE_POINTS = 2000  # (b) the library, 0.5 px noise, on the card and the CPU
NOISE_PASSES = 3
NOISE_ROT_TOL = 1e-6  # rad: card vs CPU, refined rotations
NOISE_PX_TOL = 1e-4  # px: card vs CPU, principal point and focal length
MATCH_PERTURB = 0.004  # (c) rad, principal point kept (tests/test_matches.py)
CELL_DEGREES = 1.0  # (c) the calibration scene's large cells at 2048 px
CLI_AGREE = 1e-9  # (c) each CLI route vs the library on its positions, max-abs
ROUTE_POSITIONS = 2.0**-12  # (c) one float32 ulp at 2048 px: JSON positions vs float32's
ORB_PAIR_MS_LEARNED = 72.9  # (c) ms a pair of the former matcher (its own learned BRIEF table)
# phase 20: a vignetting sweep, SWEEP_GRID x SWEEP_GRID target positions
SWEEP_SIZE = 2048
SWEEP_GRID = 10
SWEEP_NOISE = 0.004
SWEEP_TARGET = 0.6  # the grey target over a 0.05 background, before rolloff
SWEEP_HALF = 12  # the target is a (2 x 12 + 1) px square
ROLLOFF_X = (0.55, 0.95, 1.1, 0.95, 0.6)  # the sweep's separable Bezier rolloff
ROLLOFF_Y = (0.6, 1.0, 1.05, 0.9, 0.5)
ROLLOFF_CPU_TOL = 1e-6  # the card's ISP JSON rolloff vs the CPU's
CHART_SIZE = 2048  # phase 21: a rig camera's frame
CHART_SCALE = 1.5  # the chart's geometry x 1.5: 54 px patches, 15 px separators
CHART_CAMERAS = 17
CHART_NOISE = 0.01
CHART_PERSPECTIVE = 0.04  # the largest of the cameras' perspectives
CHART_BL = (0.04, 0.05, 0.06)  # TestColorSolve's black level and colour matrix
CHART_M = ((1.6, -0.3, -0.1), (-0.2, 1.5, -0.2), (-0.1, -0.4, 1.8))
CHART_CENT_TOL = 5.0  # px (tests/test_calib_color.py's combined fixture)
BL_TOL = 0.02  # recovered black level vs the truth (TestColorSolve)
GREY_TOL = 0.02  # WB x CCM maps grey to grey (TestColorSolve)
COLOR_CPU_TOL = 1e-9  # the card's ISP JSONs vs the CPU's (black level / full scale)
MESH_FRAMES = 4  # phase 22: (data 2, ring 7) renders 2 chunks of 2 frames
MESH_TOL = 1e-4  # mesh vs the sequential chain (the reference's dryrun_multichip bound)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's line
BENCH_LEGACY_FRAMES = 2  # batches the legacy bench times (its default is 5)
BENCH_TIMEOUT_S = 900  # each bench subprocess
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


def call_bounds(args, kw) -> dict:
    """What one call must move and compute, and the least time an H100
    could take for it: the larger of bytes / 3.35 TB/s and FLOPs /
    67 TFLOP/s. Bytes: coordinates (8 B a sample), window origins (8 B a
    window) and outputs (4 B each) once, and the source pixels that the
    taps read (``s360bench/bounds.py``'s ``touched_px``) once: the
    benchmark's ``call_bytes``. ``window_src_bytes``, beside it, is the
    source as the whole padded array or, where smaller, the union of the
    call's windows. FLOPs: :func:`flops_per_sample`."""
    padded, sy, sx, xt, _ = args
    L, C, Hp, Wp = padded.shape
    T, _, P = xt.shape
    offs = kw.get("offsets")
    O = len(offs) if offs else 1
    wx = kw["bw"] if (kw.get("base_bw") is None or offs) else kw["base_bw"]
    union = window_union_px(sy, sx, kw["bh"], wx, Hp, Wp)
    union_px = int(union.sum()) if sy.ndim == 2 else int(union[0]) * L
    src_bytes = 4 * C * touched_px(args, kw)
    nbytes = call_bytes(args, kw)
    flops = T * L * P * flops_per_sample(kw["interpolation"], C, O)
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
    from surround360_tpu_torch import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    for source, secs in seconds.items():
        log(f"[2 build] {source}: nvcc {secs:.1f} s")
        for line in cuda_build.ptxas_report(source):
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
    # C = 3 (staged as 4 floats a pixel) under windows as wide as a padded
    # 6k / 8k panorama row, the cubemap's polar faces: one row is 101 /
    # 135 KB, above a block's share of shared memory in either block shape
    # (P = 2048: 256 threads; P = 512: 128 threads), so a band is one row.
    # Tile 0 sweeps every column, tile 1 is compact
    for wide_w, P_ in ((6320, 2048), (8424, 512)):
        wide = rng.random((1, 3, 40, wide_w), dtype=np.float32)
        kw = dict(pad_y=3, pad_x=8, n_y=34, n_x=wide_w - 16, bh=32, bw=wide_w,
                  interpolation="bicubic", border="constant", base_bw=None)
        sy = np.array([[0], [8], [0], [4]], np.int32)
        sx = np.zeros((4, 1), np.int32)
        xt, yt = _edge_coords(rng, sy, sx, 32, wide_w, (4, 1, P_))
        xt[1] = 3000.0 + rng.uniform(0, 100, (1, P_)).astype(np.float32)
        yield "fused_window_sample", f"edge/wide/C=3/Wp={wide_w}/P={P_}", (
            wide, sy, sx, xt, yt), kw
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


def _refused_launch():
    """A window row that no block's shared memory holds: the wrapper must
    raise (cudaErrorInvalidValue, no launch counted) and leave the device
    usable. Returns the failure, or None."""
    import torch

    from surround360_tpu_torch.cuda_build import launch_count
    from surround360_tpu_torch.ops import fused_window as fw

    W = 15000
    src = torch.rand((1, 3, 8, W), device="cuda")
    origin = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    xt = torch.rand((1, 1, 64), device="cuda") * (W - 1)
    yt = torch.rand((1, 1, 64), device="cuda") * 7
    kw = dict(bh=8, pad_y=0, pad_x=0, n_y=8, n_x=W, interpolation="bicubic",
              border="constant")
    before = launch_count()
    try:
        fw.fused_window_sample(src, origin, origin, xt, yt, bw=W, **kw)
    except RuntimeError as e:
        if "CUDA error 1" not in str(e):
            return f"a refused launch raised another error: {e}"
    else:
        return "a 15000 px window row did not raise"
    if launch_count() != before:
        return "a refused launch was counted"
    got = fw.fused_window_sample(src, origin, origin, xt, yt, bw=W, base_bw=6000,
                                 **kw)
    want = fw.fused_window_sample_reference(src, origin, origin, xt, yt, bw=W,
                                            base_bw=6000, **kw)
    err = float((got - want).abs().max())
    return None if err <= TOL else f"the launch after a refused one: max-abs {err}"


def phase_small():
    """Every small case, kernel vs twin. Returns (worst max-abs per kernel,
    the failed cases); a failure is printed here and fails the run at its
    end, so that the later phases still measure."""
    import torch

    from surround360_tpu_torch.cuda_build import launch_count

    worst: dict = {}
    failed = []
    rng = np.random.default_rng(0)
    for kernel, name, arrays, kw in _small_cases(rng):
        call, twin = _twin_call(kernel)
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        before = launch_count(kernel)
        got = call(*dev, **kw)
        torch.cuda.synchronize()
        want = twin(*dev, **kw)
        err = float((got - want).abs().max())
        bad = not torch.isfinite(got).all() or err > TOL
        if bad:
            failed.append(f"{kernel} vs twin {name}: max-abs {err}")
            log(f"[3 small] FAILED {failed[-1]}")
        if launch_count(kernel) != before + 1:
            failed.append(f"{kernel} {name}: {launch_count(kernel) - before} launches counted")
            log(f"[3 small] FAILED {failed[-1]}")
        n, n_bad, w = worst.get(kernel, (0, 0, 0.0))
        worst[kernel] = (n + 1, n_bad + bad, max(w, err))
    refused = _refused_launch()
    if refused:
        failed.append(refused)
        log(f"[3 small] FAILED {refused}")
    else:
        log("[3 small] a 15000 px window row (240 KB at C = 3) is refused: the "
            "wrapper raised, nothing was counted, and the next launch ran")
    for kernel, (n, n_bad, err) in worst.items():
        log(f"[3 small] {kernel} vs twin, {n} cases: max-abs {err:.3g} "
            + (f"({n_bad} FAILED)" if n_bad else f"(<= {TOL})"))
    return {k: v[2] for k, v in worst.items()}, failed


def _render_inputs(rig, device):
    from surround360_tpu_torch.benchmarks.preset_table import frame_inputs
    from surround360_tpu_torch.capture import checker_sinusoid_environment

    views = _render_views(rig, checker_sinusoid_environment)
    return frame_inputs(rig, views, device), views


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _frames_counted(module):
    """While open, each ``render_frame`` call made through ``module``
    appends to the yielded list what the launch account gained since the
    last frame, per (kernel, site), and the counters of the tracer's
    ``flow.level`` spans recorded since (captures, replays, eager
    levels)."""
    from surround360_tpu_torch import cuda_build
    from surround360_tpu_torch.utils import tracing

    frames, inner = [], module.render_frame
    seen = [collections.Counter(cuda_build.LAUNCHES), len(tracing.session())]

    def counted(*args, **kw):
        out = inner(*args, **kw)
        now, spans = collections.Counter(cuda_build.LAUNCHES), tracing.session()
        frames.append((now - seen[0], _graph_counts(spans[seen[1]:])))
        seen[:] = now, len(spans)
        return out

    module.render_frame = counted
    try:
        yield frames
    finally:
        module.render_frame = inner


def _graph_counts(spans):
    """The ``flow.graph.*`` counters (captures, replays, eager levels) of
    the tracer's ``flow.level`` spans among ``spans``, summed."""
    levels = collections.Counter()
    for sp in spans:
        if sp.name == "flow.level":
            levels.update({k: n for k, n in sp.counts.items() if k.startswith("flow.graph.")})
    return levels


def _check_graphed(phase, graphed, recorded=None):
    """``graphed``, the frames of a run with no record open
    (:func:`_frames_counted`, under ``tracing.recording()``), took the
    flow's level graphs: no level ran eagerly. With ``recorded``, the
    frames of a run with the record open, the last graphed frame replayed
    every level and captured none, and launched per (kernel, site) what
    the last recorded frame launched eagerly. Returns the graph counters
    summed over the frames."""
    levels = sum((lv for _, lv in graphed), collections.Counter())
    if levels["flow.graph.eager"] or not levels:
        raise AssertionError(f"[{phase}] flow levels not graphed: {dict(levels)}")
    if recorded is not None:
        launched, last = graphed[-1]
        if set(last) != {"flow.graph.replay"} or launched != recorded[-1][0]:
            raise AssertionError(
                f"[{phase}] the last frame's levels {dict(last)}; it launched "
                f"{dict(launched)}, the recorded frame {dict(recorded[-1][0])}")
    return dict(levels)


def phase_main_path(rig, preset, device):
    """Two chained frames through the user entry points with the per-call
    record open, then three with none (the flow's levels graphed); returns
    the context, inputs, views, the graphed run's launches per kernel, the
    recorded calls and the graphed run's seconds a frame."""
    import torch

    from surround360_tpu_torch.benchmarks.preset_table import preset_config
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.render import panorama
    from surround360_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    inputs, views = _render_inputs(rig, device)
    t1 = time.perf_counter()
    ctx = panorama.build_render_context(rig, preset_config(preset))
    log(f"[4 main] simulator views {t1 - t0:.1f} s, build_render_context "
        f"{time.perf_counter() - t1:.1f} s (strip {ctx.strip_h}x"
        f"{ctx.strip_w}, poles {ctx.top_h} rows)")

    def chain(n, times):
        state = None
        for frame in range(n):
            t0 = time.perf_counter()
            out, state = panorama.render_frame(ctx, *inputs, state=state,
                                               use_temporal=frame > 0)
            _sync(device)
            times.append(time.perf_counter() - t0)
        return out

    reset_launch_counts()
    with fw.recorded() as record, _frames_counted(panorama) as recorded:
        chain(FRAMES, [])
    # as users run it: no record open, so the flow's levels run as graphs
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    reset_launch_counts()
    with tracing.recording(), _frames_counted(panorama) as graphed:
        out = chain(GRAPHED_FRAMES, times)
    levels = _check_graphed("4 main", graphed, recorded)
    sites = {s: launch_count(fw.K1, s) for s in K1_SITES}
    launches = {k: launch_count(k) for k in fw.KERNELS}
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
        f"{tuple(eqr.shape)}, no record open: frame 0 {times[0]:.3f} s, frame 1 "
        f"(temporal) {times[1]:.3f} s, frame 2 (replayed) {times[2]:.3f} s, peak "
        f"{peak:.2f} GiB, flow levels {levels}, K1 sites {sites}, launches {launches}")
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
    """Frame 0 as 16-bit PNGs with the port's writer; frames 1 and 2
    hard-link frame 0."""
    from surround360_tpu_torch.cli.common import write_image
    from surround360_tpu_torch.geometry.rig import save_rig

    os.makedirs(imgs, exist_ok=True)
    rig_path = os.path.join(WORK, "rig.json")
    save_rig(rig_path, rig)

    def one(i):
        d = os.path.join(imgs, rig.ids[i])
        os.makedirs(d, exist_ok=True)
        write_image(os.path.join(d, "000000.png"), views[i], bit_depth=16)
        for f in (1, 2):
            os.link(os.path.join(d, "000000.png"), os.path.join(d, f"{f:06d}.png"))

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
    """The video CLI at 6k with pixflow_tpu_offsets: chained with the
    per-call record open, chained with none (the flow's levels graphed)
    and resumed. Returns the graphed run's launches per kernel and the
    recorded K3 calls."""
    import torch

    from surround360_tpu_torch.cli import render_video
    from surround360_tpu_torch.cli.common import read_image_rgba
    from surround360_tpu_torch.cli.render_video import QUALITY_PRESETS
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.utils import tracing

    shutil.rmtree(WORK, ignore_errors=True)
    imgs = os.path.join(WORK, "imgs")
    t0 = time.perf_counter()
    rig_path = _write_footage(rig, views, imgs)
    log(f"[7 cli] {len(rig.ids)} cameras x {GRAPHED_FRAMES} frames as 16-bit PNGs in "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--rig_json_file", rig_path, "--imgs_dir", imgs, "--quality",
              PRESET, "--enable_top", "--enable_bottom",
              "--side_flow_alg", "pixflow_tpu_offsets",
              "--polar_flow_alg", "pixflow_tpu_offsets"]
    chained = os.path.join(WORK, "chained")
    states = os.path.join(WORK, "state")
    with fw.recorded() as record, _frames_counted(render_video) as recorded:
        state, wall, stages, peak = _video(
            common + ["--output_dir", chained, "--start_frame", "0",
                      "--end_frame", "1", "--save_state_dir", states])
    # as users run it: no record open, so every flow level runs as a graph
    reset_launch_counts()
    with tracing.recording(), _frames_counted(render_video) as graphed:
        _, g_wall, g_stages, g_peak = _video(
            common + ["--output_dir", os.path.join(WORK, "graphed"), "--start_frame", "0",
                      "--end_frame", str(GRAPHED_FRAMES - 1)])
    levels = _check_graphed("7 cli", graphed, recorded)
    sites = {s: launch_count(fw.K3, s) for s in FLOW_SITES}
    replayed = {s: graphed[-1][0][(fw.K3, s)] for s in FLOW_SITES}
    launches = {k: launch_count(k) for k in fw.KERNELS}
    if not all(replayed.values()):
        raise AssertionError(f"K3 not launched at every flow site of the replayed "
                             f"frame: {replayed}")
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
    graphed_err = max(float(np.abs(read_image_rgba(os.path.join(
        WORK, "graphed", "eqr_frames", f"eqr_{f:06d}.png")) - frames[f]).max()) for f in (0, 1))
    if graphed_err:
        raise AssertionError(f"graphed frames 0-1 differ from the recorded ones by {graphed_err}")
    loop_s, g_loop_s = stages["loop"][1], g_stages["loop"][1]
    log(f"[7 cli] render_video {PRESET} pixflow_tpu_offsets, 2 frames recorded: "
        f"{loop_s / 2:.3f} s/frame ({loop_s:.3f} s loop, {wall:.1f} s with "
        f"context), peak {peak:.2f} GiB")
    log("[7 cli] loop stages, seconds summed (entries): " + ", ".join(
        f"{name} {secs:.3f} ({n})" for name, (n, secs) in stages.items()))
    log(f"[7 cli] {GRAPHED_FRAMES} frames with no record open: {g_loop_s / GRAPHED_FRAMES:.3f} "
        f"s/frame ({g_loop_s:.3f} s loop, {g_wall:.1f} s with context), peak {g_peak:.2f} "
        f"GiB, flow levels {levels}, K3 sites {sites} (the replayed frame {replayed}), "
        f"launches {launches}; frames 0-1 equal to the recorded run's (max-abs 0)")

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
    with fw.recorded() as rec:
        fn(xs, ys)
    k2 = _site_check("8 flow sites", (fw.K2, "side_flow_level0", None), rec, 0)
    return k3, k2


# A non-trivial ISP config for the unpack phase: black level, white
# balance, vignette roll-off, a CCM with saturation, gamma, sharpening.
ISP_KW = dict(
    bits_per_pixel=12, bayer_pattern="GBRG", black_level=(64.0, 64.0, 64.0),
    white_balance_gain=(1.25, 1.0, 1.4),
    vignette_rolloff_h=((1.2, 1.2, 1.2), (0.9, 0.9, 0.9), (1.2, 1.2, 1.2)),
    vignette_rolloff_v=((1.15, 1.15, 1.15), (0.92, 0.92, 0.92), (1.15, 1.15, 1.15)),
    ccm=((1.15, -0.1, -0.05), (-0.08, 1.2, -0.12), (-0.02, -0.13, 1.15)),
    saturation=1.1, gamma=(0.4545, 0.4545, 0.4545), sharpening=(0.25, 0.25, 0.25),
)


def _sensor_raw12(view, cfg):
    """What a sensor behind ``cfg``'s ISP would have recorded of ``view``
    (4, H, W): the ISP's stages backwards (tone curve as its gamma alone,
    composite CCM, white balance, vignette, black level), mosaiced, as
    12-bit values (H, W) uint16. The ISP then returns the view, up to its
    demosaic, quantization and sharpening."""
    from surround360_tpu_torch.isp import pipeline as isp

    H, W = view.shape[-2:]
    lin = np.stack([np.power(view[c], 1.0 / cfg.gamma[c]) for c in range(3)])
    m = isp.build_composite_ccm(cfg).astype(np.float64) / (isp.TONE_CURVE_LUT_SIZE - 1)
    sensor = np.tensordot(np.linalg.inv(m), lin, axes=[[1], [0]])
    vh, vv = isp.build_vignette_gains(cfg, H, W)
    red, green, _, _ = isp.bayer_masks(cfg, H, W)
    planes = []
    for c in range(3):
        gain = cfg.white_balance_gain[c] * vv[:, c, None] * vh[None, :, c]
        bl = cfg.black_level[c] / cfg.max_pixel_value
        planes.append(np.clip(sensor[c] / gain, 0.0, 1.0) * (1.0 - bl) + bl)
    mosaic = np.where(red, planes[0], np.where(green, planes[1], planes[2]))
    return np.clip(mosaic * 4095.0 + 0.5, 0, 4095).astype(np.uint16)


def _pole_boxes(H, W):
    """The painted pole of each bottom camera and the primary mask's
    interior, as tests/test_pole_removal.py places them at 256 px:
    (primary, secondary, interior) as (y0, y1, x0, x1)."""
    k, cy, cx = H / 256.0, H // 2, W // 2
    box = lambda a, b, c, d: (cy + int(a * k), cy + int(b * k), cx + int(c * k),
                              cx + int(d * k))
    return box(-24, 24, -20, 20), box(-70, -30, 30, 70), box(-12, 12, -8, 8)


def _write_capture(root, rig, views, frames=2):
    """Raw footage of ``views`` under ``root``: bins/0.bin (every camera,
    ``frames`` times the same frame), isp/<serial>.json, rig.json, and
    masks/<camera id>.png (red over the pole painted into both bottom
    cameras). Returns the painted views (the cameras' order) and the ISP
    config."""
    from surround360_tpu_torch import native
    from surround360_tpu_torch.cli.common import write_image
    from surround360_tpu_torch.geometry.rig import save_rig
    from surround360_tpu_torch.isp import pack_12bit_frame, write_footage_file
    from surround360_tpu_torch.isp.pipeline import IspConfig

    cfg = IspConfig(**ISP_KW)
    for d in ("bins", "isp", "masks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    save_rig(os.path.join(root, "rig.json"), rig)
    H, W = views[0].shape[-2:]
    painted = list(views)
    bottoms = (rig.bottom_camera_index, rig.bottom_camera2_index)
    for cam, (y0, y1, x0, x1) in zip(bottoms, _pole_boxes(H, W)[:2]):
        painted[cam] = views[cam].copy()
        painted[cam][:3, y0:y1, x0:x1] = 0.05
        mask = np.zeros((4, H, W), np.float32)
        mask[0, y0:y1, x0:x1] = 1.0
        mask[3] = 1.0
        write_image(os.path.join(root, "masks", f"{rig.ids[cam]}.png"), mask)
    serials = [10000 + i for i in range(len(rig.ids))]
    for serial in serials:
        with open(os.path.join(root, "isp", f"{serial}.json"), "w") as f:
            json.dump(cfg.to_json(), f)
    pack = native.pack12_native if native.available() else pack_12bit_frame
    with ThreadPoolExecutor(8) as pool:
        payloads = list(pool.map(lambda v: pack(_sensor_raw12(v, cfg)), painted))
    write_footage_file(os.path.join(root, "bins", "0.bin"), [payloads] * frames,
                       W, H, 12, serials)
    return painted, cfg


def phase_unpack(rig, views, device_name="cuda"):
    """Raw footage -> the unpack CLI on the card -> 16-bit PNG trees.
    Returns the capture's root (rig.json, masks/, raw/)."""
    import torch

    from surround360_tpu_torch import native
    from surround360_tpu_torch.cli import unpack
    from surround360_tpu_torch.cli.common import StageTimer, read_image_rgba
    from surround360_tpu_torch.isp import BinaryFootageReader, pack_12bit_frame
    from surround360_tpu_torch.isp import raw as rawmod
    from surround360_tpu_torch.isp.pipeline import isp_process

    root = os.path.join(WORK, "capture")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    painted, cfg = _write_capture(root, rig, views, FRAMES)
    H, W = painted[0].shape[-2:]
    log(f"[10 unpack] raw footage: {len(rig.ids)} cameras x {FRAMES} frames of "
        f"{W}x{H} 12-bit {cfg.bayer_pattern} in one .bin, made in "
        f"{time.perf_counter() - t0:.1f} s (native library: {native.available()})")

    timer = StageTimer()
    t0 = time.perf_counter()
    cams = unpack.main(
        ["--binary_prefix", os.path.join(root, "bins"), "--dest_path",
         os.path.join(root, "raw"), "--isp_dir", os.path.join(root, "isp"),
         "--output_bpp", "16", "--device", device_name], timer=timer)
    wall = time.perf_counter() - t0
    if cams != list(rig.ids):
        raise AssertionError(f"unpacked {cams}, want {rig.ids}")

    def interior_err(i):
        errs = []
        for f in range(FRAMES):
            img = read_image_rgba(os.path.join(root, "raw", cams[i], f"{f:06d}.png"))
            if img.shape != (4, H, W) or not np.isfinite(img).all():
                raise AssertionError(f"bad unpacked frame {cams[i]}/{f}: {img.shape}")
            m = max(8, H // 32)
            errs.append(float(np.abs(img[:3, m:-m, m:-m] - painted[i][:3, m:-m, m:-m]).mean()))
        return max(errs)

    with ThreadPoolExecutor(8) as pool:
        errs = list(pool.map(interior_err, range(len(cams))))
    if max(errs) > ISP_MEAN_ERR:
        raise AssertionError(f"unpacked frames off the simulator's views: {errs}")

    # the ISP on the device against the ISP on the CPU, one camera; the
    # native converters against the numpy ones, one frame
    reader = BinaryFootageReader(os.path.join(root, "bins", "0.bin"))
    buf = bytes(reader.get_frame_bytes(0, 1))
    raw16 = rawmod.convert_12bit_numpy(buf, W, H)
    if native.available():
        if not np.array_equal(native.convert12_native(buf, W, H), raw16):
            raise AssertionError("native 12-bit conversion differs from numpy")
        vals = raw16 >> 4
        if native.pack12_native(vals) != pack_12bit_frame(vals):
            raise AssertionError("native 12-bit packing differs from numpy")
        buf8 = buf[: W * H]
        if not np.array_equal(native.convert8_native(buf8, W, H),
                              rawmod.convert_8bit_numpy(buf8, W, H)):
            raise AssertionError("native 8-bit conversion differs from numpy")
    elif device_name == "cuda":
        raise AssertionError("the native footage library did not build")
    rawf = torch.from_numpy(raw16.astype(np.float32) / 65535.0)
    device = torch.device(device_name)
    on_dev = isp_process(rawf.to(device), cfg).cpu()
    on_cpu = isp_process(rawf, cfg)
    diff = (on_dev - on_cpu).abs()
    err, share = float(diff.max()), float((diff > 1e-4).float().mean())
    if err > ISP_STEP_MAX or share > ISP_FLIPS_MAX:
        raise AssertionError(f"ISP on {device_name} vs CPU: max-abs {err}, share {share}")
    batch = rawf.to(device)[None].expand(FRAMES, H, W).contiguous()
    isp_ms = (cuda_ms(lambda: isp_process(batch, cfg)) / FRAMES
              if device.type == "cuda" else float("nan"))
    stages = timer.totals()
    log(f"[10 unpack] unpack.main on {device_name}: {len(cams)} cameras x {FRAMES} "
        f"frames as 16-bit PNGs in {wall:.3f} s ({wall / FRAMES:.3f} s/frame); host "
        "stages, seconds summed (entries): " + ", ".join(
            f"{name} {secs:.3f} ({n})" for name, (n, secs) in stages.items()))
    log(f"[10 unpack] ISP {isp_ms:.3f} ms per frame and camera ({W}x{H}, "
        f"{cfg.demosaic_filter}, sharpening on; CUDA events, batch of {FRAMES}); "
        f"interior mean error vs the simulator's views: worst camera "
        f"{max(errs):.5f} (<= {ISP_MEAN_ERR}); ISP on {device_name} vs CPU, "
        f"{cams[1]}: max-abs {err:.3g} (<= {ISP_STEP_MAX}), off by > 1e-4 on "
        f"{share:.3%} of values (<= {ISP_FLIPS_MAX:.1%}); native converters equal numpy")
    return root, painted


def _pole_quality(root, rig, painted, views, device):
    """Pole removal on the unpacked frame-0 PNGs of the two bottom cameras
    (what the CLI computes first): alpha under the primary mask, and PSNR
    of the mask's interior to the unpainted view."""
    import torch

    from surround360_tpu_torch.cli.common import read_image_rgba
    from surround360_tpu_torch.cli.render_video import _load_pole_mask
    from surround360_tpu_torch.flow import make_flow_params
    from surround360_tpu_torch.geometry.camera import approximate_usable_pixels_radius
    from surround360_tpu_torch.render.pole import combine_bottom_images_with_pole_removal

    i1, i2 = rig.bottom_camera_index, rig.bottom_camera2_index
    cams = [rig.cameras[i] for i in (i1, i2)]
    imgs = [torch.from_numpy(read_image_rgba(
        os.path.join(root, "raw", rig.ids[i], "000000.png"))).to(device) for i in (i1, i2)]
    H, W = imgs[0].shape[-2:]
    masks = [_load_pole_mask(os.path.join(root, "masks"), rig.ids[i], (H, W))
             for i in (i1, i2)]
    combined, _ = combine_bottom_images_with_pole_removal(
        *imgs, *masks, *[approximate_usable_pixels_radius(c) for c in cams],
        bool(np.dot(np.asarray(cams[0].up), np.asarray(cams[1].up)) < 0),
        make_flow_params(FLOW_ALG))
    combined = combined.cpu().numpy()
    y0, y1, x0, x1 = _pole_boxes(H, W)[2]
    inner = (slice(None, 3), slice(y0, y1), slice(x0, x1))
    mse = lambda a, b: float(np.mean((a - b) ** 2))
    psnr = lambda a, b: 10.0 * np.log10(1.0 / max(mse(a, b), 1e-12))
    return (float(combined[3][masks[0]].min()), psnr(combined[inner], views[i1][inner]),
            psnr(combined[inner], painted[i1][inner]))


def phase_product_cli(rig, root, painted, views, preset=PRESET, cube=CUBE,
                      device_name="cuda"):
    """The product's video CLI on the unpacked PNGs: pole removal, cubemap,
    chained with the per-call record open, chained with none (the flow's
    levels graphed) and resumed. Returns the graphed run's launches per
    kernel and the recorded calls."""
    import torch

    from surround360_tpu_torch.cli import render_video
    from surround360_tpu_torch.cli.common import read_image_rgba
    from surround360_tpu_torch.cli.render_video import QUALITY_PRESETS
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.utils import tracing

    common = ["--rig_json_file", os.path.join(root, "rig.json"), "--imgs_dir",
              os.path.join(root, "raw"), "--quality", preset, "--enable_top",
              "--enable_bottom", "--enable_pole_removal", "--bottom_pole_masks_dir",
              os.path.join(root, "masks"), "--cubemap_width", str(cube),
              "--cubemap_height", str(cube), "--cubemap_format", "video",
              "--side_flow_alg", FLOW_ALG, "--polar_flow_alg", FLOW_ALG,
              "--poleremoval_flow_alg", FLOW_ALG, "--device", device_name]
    chained, states = os.path.join(root, "chained"), os.path.join(root, "state")
    with fw.recorded() as record:
        state, wall, stages, peak = _video(
            common + ["--output_dir", chained, "--start_frame", "0", "--end_frame",
                      str(FRAMES - 1), "--save_state_dir", states])
    # as users run it: no record open, so every flow level runs as a graph
    reset_launch_counts()
    with tracing.recording(), _frames_counted(render_video) as graphed:
        _, g_wall, g_stages, _ = _video(
            common + ["--output_dir", os.path.join(root, "graphed"), "--start_frame", "0",
                      "--end_frame", str(FRAMES - 1)])
    levels = _check_graphed("11 product cli", graphed) if device_name == "cuda" else {}
    k1_sites = {s: launch_count(fw.K1, s) for s in K1_SITES + K1_PRODUCT_SITES}
    k3_sites = {s: launch_count(fw.K3, s) for s in FLOW_SITES + (POLE_REMOVAL_FLOW,)}
    launches = {k: launch_count(k) for k in fw.KERNELS}
    if device_name == "cuda":
        missing = [s for s, n in {**k1_sites, **k3_sites}.items() if n == 0]
        if missing:
            raise AssertionError(f"no kernel launch at {missing}: {k1_sites} {k3_sites}")
        if launches[fw.K2]:
            raise AssertionError(f"K2 launched on the product path: {launches}")
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        raise AssertionError("non-finite temporal state")
    _, _, fin_w, fin_h = QUALITY_PRESETS[preset]
    want = {"eqr": (4, fin_h, fin_w), "cube": (4, 2 * 2 * cube, 3 * cube)}
    read = lambda out, kind, f: read_image_rgba(
        os.path.join(out, "eqr_frames", f"{kind}_{f:06d}.png"))
    last = {}
    for kind, shape in want.items():
        for f in range(FRAMES):
            last[kind] = read(chained, kind, f)
            if last[kind].shape != shape or not np.isfinite(last[kind]).all():
                raise AssertionError(f"bad {kind} frame {f}: {last[kind].shape} != {shape}")
    errs = {f"{kind} {f}": float(np.abs(read(os.path.join(root, "graphed"), kind, f)
                                        - read(chained, kind, f)).max())
            for kind in want for f in range(FRAMES)}
    if any(errs.values()):
        raise AssertionError(f"graphed frames differ from the recorded ones: {errs}")
    loop_s, g_loop_s = stages["loop"][1], g_stages["loop"][1]
    log(f"[11 product cli] render_video {preset} {FLOW_ALG} with pole removal and a "
        f"{cube} px cubemap, {FRAMES} frames recorded: {loop_s / FRAMES:.3f} s/frame "
        f"({loop_s:.3f} s loop, {wall:.1f} s with context), peak {peak:.2f} GiB, "
        f"equirect {want['eqr'][1:]}, cubemap {want['cube'][1:]}")
    log("[11 product cli] loop stages, seconds summed (entries): " + ", ".join(
        f"{name} {secs:.3f} ({n})" for name, (n, secs) in stages.items()))
    log(f"[11 product cli] {FRAMES} frames with no record open: {g_loop_s / FRAMES:.3f} "
        f"s/frame ({g_wall:.1f} s with context), flow levels {levels}, K1 sites "
        f"{k1_sites}, K3 sites {k3_sites}, launches {launches}; equal to the recorded "
        f"frames (max-abs 0)")

    resumed = os.path.join(root, "resumed")
    f1 = FRAMES - 1
    _, wall, _, _ = _video(
        common + ["--output_dir", resumed, "--start_frame", str(f1), "--end_frame",
                  str(f1), "--resume_state",
                  os.path.join(states, f"state_{f1 - 1:06d}.pkl")])
    errs = {kind: float(np.abs(read(resumed, kind, f1) - last[kind]).max())
            for kind in want}
    log(f"[11 product cli] frame {f1} resumed from state_{f1 - 1:06d}.pkl ({wall:.1f} s "
        f"with context and IO): max-abs vs chained {errs} (must be 0)")
    if any(errs.values()):
        raise AssertionError(f"resumed frame differs: {errs}")

    alpha, p_clean, p_pole = _pole_quality(root, rig, painted, views,
                                           torch.device(device_name))
    log(f"[11 product cli] pole removal on the unpacked bottom frames: alpha under the "
        f"primary mask >= {alpha:.3f} (> 0.9), mask interior vs the unpainted view "
        f"{p_clean:.2f} dB (>= {POLE_PSNR_MIN}), vs the painted one {p_pole:.2f} dB")
    if alpha <= 0.9 or p_clean < POLE_PSNR_MIN or p_clean < p_pole + 10.0:
        raise AssertionError(f"pole not removed: alpha {alpha}, {p_clean} / {p_pole} dB")
    return launches, record


def phase_product_sites(record):
    """The recorded calls of the product path's new kernel sites: K1 at the
    cubemap's two remaps and the pole-removal warp, K3 at the pole-removal
    flow (per offset set), as phases 5 and 8."""
    from surround360_tpu_torch.ops import fused_window as fw

    k1 = [_site_check("12 new sites", (fw.K1, site, None), record,
                      record[(fw.K1, site, None)][3] / FRAMES)
          for site in K1_PRODUCT_SITES]
    d = lambda offs: max(abs(v) for o in offs for v in o)
    keys = sorted((k for k in record if k[:2] == (fw.K3, POLE_REMOVAL_FLOW)),
                  key=lambda k: -d(k[2]))
    if not keys:
        raise AssertionError("no K3 record at the pole-removal flow")
    k3 = [_site_check("12 new sites", k, record, record[k][3] / FRAMES) for k in keys]
    return k1, k3


DEBUG_FILES = ([f"crop_cam{i}.png" for i in range(1, 15)]
               + ["spherical_l.png", "spherical_r.png", "top_strip.png",
                  "bottom_strip.png"]
               + [f"{pole}_warped_{eye}.png" for pole in ("top", "bottom")
                  for eye in ("left", "right")])


def phase_debug_profile(rig, root, device_name="cuda", small_scale=0.25):
    """--save_debug_images and --profile_stages at the preview preset, then
    run_all (unpack, render) on a small footage."""
    import logging

    from surround360_tpu_torch.capture import render_camera_views
    from surround360_tpu_torch.cli import render_video, run_all
    from surround360_tpu_torch.cli.common import read_image_rgba
    from surround360_tpu_torch.render.profiling import STAGES

    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = logging.getLogger("surround360_tpu_torch")
    logger.addHandler(handler)
    out = os.path.join(root, "debug_run")
    t0 = time.perf_counter()
    try:
        render_video.main(
            ["--rig_json_file", os.path.join(root, "rig.json"), "--imgs_dir",
             os.path.join(root, "raw"), "--output_dir", out, "--quality", "preview",
             "--enable_top", "--enable_bottom", "--side_flow_alg", FLOW_ALG,
             "--polar_flow_alg", FLOW_ALG, "--save_debug_images", "--profile_stages",
             "--device", device_name])
    finally:
        logger.removeHandler(handler)
    wall = time.perf_counter() - t0
    got = sorted(os.listdir(os.path.join(out, "debug", "000000")))
    if got != sorted(DEBUG_FILES):
        raise AssertionError(f"debug tree {got}")
    table = next((ln for ln in lines if ln.startswith("stage breakdown")), None)
    if table is None:
        raise AssertionError("--profile_stages logged no stage table")
    named = [ln.split()[0] for ln in table.splitlines()[1:]]
    if not set(STAGES) <= set(named):
        raise AssertionError(f"stage table lacks {set(STAGES) - set(named)}")
    log(f"[13 debug] preview frame with --save_debug_images --profile_stages in "
        f"{wall:.1f} s: {len(got)} debug images; the table:")
    for ln in table.splitlines():
        log(f"[13 debug] {ln}")

    small = os.path.join(WORK, "small")
    shutil.rmtree(small, ignore_errors=True)
    rig_s = rig.rescaled(small_scale)
    _write_capture(small, rig_s, render_camera_views(rig_s), FRAMES)
    dest = os.path.join(small, "dest")
    t0 = time.perf_counter()
    run_all.main(
        ["--steps", "unpack,render", "--binary_prefix", os.path.join(small, "bins"),
         "--isp_dir", os.path.join(small, "isp"), "--rig_json_file",
         os.path.join(small, "rig.json"), "--dest_dir", dest, "--quality", "preview",
         "--frame_count", str(FRAMES), "--enable_top", "--enable_bottom",
         "--flow_alg", FLOW_ALG, "--device", device_name])
    wall = time.perf_counter() - t0
    with open(os.path.join(dest, "runtimes.txt")) as f:
        runtimes = f.read().splitlines()
    if [ln.split(":")[0] for ln in runtimes] != ["unpack", "render"]:
        raise AssertionError(f"runtimes.txt: {runtimes}")
    for f in range(FRAMES):
        img = read_image_rgba(os.path.join(dest, "eqr_frames", f"eqr_{f:06d}.png"))
        if img.shape != (4, 1008, 1008) or not np.isfinite(img).all():
            raise AssertionError(f"run_all frame {f}: {img.shape}")
    res = int(rig_s.cameras[0].resolution[0])
    log(f"[13 debug] run_all --steps unpack,render, preview, {res} px cameras, "
        f"{FRAMES} frames in {wall:.1f} s; runtimes.txt: {'; '.join(runtimes)}")


def phase_capture(root, frames=CAPTURE_FRAMES):
    """CaptureDaemon records phase 10's payloads (each camera's frame 0 of
    ``root``/bins/0.bin, stamped with its serial) for ``frames`` frames over
    two consumers, with one counter gap; every frame read back equal to its
    payload. Returns the directory of the two .bin files."""
    from surround360_tpu_torch.capture.daemon import CaptureDaemon
    from surround360_tpu_torch.isp import BinaryFootageReader

    src = BinaryFootageReader(os.path.join(root, "bins", "0.bin"))
    md = src.metadata
    n_cams = src.num_cameras
    payloads = [bytes(src.get_frame_bytes(0, c)) for c in range(n_cams)]
    serials = [src.get_serial(0, c) for c in range(n_cams)]
    dest = os.path.join(WORK, "recorded")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    paths = [os.path.join(dest, f"{i}.bin") for i in range(2)]
    gap_cam, gap_frame = CAPTURE_GAP

    def source(frame, cam):
        return payloads[cam], frame + int(cam == gap_cam and frame >= gap_frame)

    daemon = CaptureDaemon(paths, md.width, md.height, md.bits_per_pixel, serials)
    t0 = time.perf_counter()
    stats = daemon.record(source, frames)
    wall = time.perf_counter() - t0
    n = frames * n_cams
    if (stats.frames_produced, stats.frames_written, stats.frames_dropped) != (n, n, 1):
        raise AssertionError(f"capture stats {stats}, want {n} produced and written, 1 drop")
    for cid, path in enumerate(paths):
        r = BinaryFootageReader(path)
        cams = [c for c in range(n_cams) if c % 2 == cid]
        got_md = (r.num_frames, r.num_cameras, r.metadata.file_index, r.metadata.file_count)
        if got_md != (frames, len(cams), cid, 2):
            raise AssertionError(f"{path}: frames, cameras, index, count {got_md}")
        for f in range(frames):
            for i, c in enumerate(cams):
                if bytes(r.get_frame_bytes(f, i)) != payloads[c]:
                    raise AssertionError(f"{path}: frame {f} of camera {c} differs")
    gb = n * md.frame_size / 1e9
    log(f"[16 capture] CaptureDaemon, {n_cams} cameras x {frames} frames of "
        f"{md.width}x{md.height} {md.bits_per_pixel}-bit ({gb:.3f} GB) over 2 consumers "
        f"in {wall:.3f} s: {frames / wall:.2f} frames/s ({n / wall:.1f} camera frames/s), "
        f"{gb / wall:.3f} GB/s; drops counted {stats.frames_dropped} (camera "
        f"{gap_cam} skips a counter at frame {gap_frame}); every frame read back equal")
    return dest


def phase_preview(root, rec_dir, device_name="cuda", sizes=PREVIEW_SIZES):
    """The preview CLI on the recorded footage at each size on the device;
    frame 0 against the CPU and the environment; then the CLI on the CPU at
    the first size. Removes the recorded footage; returns the device's and
    the CPU's JPEG directories of the first size."""
    import torch

    from surround360_tpu_torch.capture import checker_sinusoid_environment
    from surround360_tpu_torch.cli import preview
    from surround360_tpu_torch.cli.common import StageTimer
    from surround360_tpu_torch.geometry.rig import load_rig
    from surround360_tpu_torch.isp import BinaryFootageReader
    from surround360_tpu_torch.render.preview import PreviewRenderer

    device = torch.device(device_name)
    on_card = device.type == "cuda"
    rig_json = os.path.join(root, "rig.json")
    rig = load_rig(rig_json)
    readers = [BinaryFootageReader(os.path.join(rec_dir, f"{i}.bin")) for i in range(2)]
    raws = preview.fisheye_raws(readers, rig, 0)
    del readers
    rig = rig.rescaled(raws[0].shape[1] / float(rig.cameras[0].resolution[0]))
    dirs = []
    for w, h, count in sizes:
        dest = os.path.join(WORK, f"preview_{w}x{h}")
        shutil.rmtree(dest, ignore_errors=True)
        argv = ["--binary_prefix", rec_dir, "--file_count", "2", "--rig_json_file",
                rig_json, "--preview_dest", dest, "--eqr_width", str(w), "--eqr_height",
                str(h), "--frame_count", str(count), "--device", device_name]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        timer = StageTimer()
        t0 = time.perf_counter()
        written = preview.main(argv, timer=timer)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        if len(written) != (count or CAPTURE_FRAMES):
            raise AssertionError(f"preview wrote {written}")
        stages = timer.totals()
        loop = sum(secs for _, secs in stages.values())
        enc_n, enc_s = stages["encode"]

        pr = PreviewRenderer(rig, eqr_width=w, eqr_height=h, device=device)
        dev_raws = [torch.from_numpy(r).to(device) for r in raws]
        ms = cuda_ms(lambda: pr.render(*dev_raws)) if on_card else float("nan")
        frame = pr.render(*dev_raws).cpu()
        if frame.shape != (3, h, w) or not bool(torch.isfinite(frame).all()):
            raise AssertionError(f"preview frame {tuple(frame.shape)}")
        err = float("nan")
        if (w, h, count) == sizes[0]:
            ref = PreviewRenderer(rig, eqr_width=w, eqr_height=h, device="cpu").render(*raws)
            err = float((frame - ref).abs().max())
            if err > PREVIEW_MAX_ERR:
                raise AssertionError(f"preview on {device_name} vs CPU: max-abs {err}")
        # the top pole against the environment, at tests/test_preview_dng.py's row
        y = h * 8 // 128
        phi = np.pi * (y + 0.5) / h
        xs = np.arange(0, w, w // 16)
        theta = 2.0 * np.pi * (1.0 - (xs + 0.5) / w)
        dirs_xyz = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                             np.full_like(theta, np.cos(phi))], -1)
        env = np.stack([checker_sinusoid_environment(v) for v in dirs_xyz], -1)
        pole = float(np.abs(frame.numpy()[:, y, xs] - env).mean())
        if pole >= POLE_ENV_ERR:
            raise AssertionError(f"top pole off the environment: mean abs {pole}")
        log(f"[17 preview] preview.main on {device_name}, {w}x{h}, {len(written)} frames "
            f"in {wall:.3f} s (renderer set-up included): render {ms:.3f} ms a frame "
            f"(CUDA events), JPEG encode {1e3 * enc_s / enc_n:.1f} ms a frame, loop "
            f"{len(written) / loop:.2f} frames/s; peak {peak:.3f} GiB; loop stages, "
            "seconds summed (entries): " + ", ".join(
                f"{name} {secs:.3f} ({n})" for name, (n, secs) in stages.items())
            + f"; frame 0 vs CPU max-abs {err:.3g} (<= {PREVIEW_MAX_ERR}), top pole "
            f"vs the environment mean abs {pole:.4f} (< {POLE_ENV_ERR})")
        dirs.append(dest)
    w, h, count = sizes[0]
    cpu_dir = os.path.join(WORK, f"preview_{w}x{h}_cpu")
    shutil.rmtree(cpu_dir, ignore_errors=True)
    t0 = time.perf_counter()
    preview.main(["--binary_prefix", rec_dir, "--file_count", "2", "--rig_json_file",
                  rig_json, "--preview_dest", cpu_dir, "--eqr_width", str(w),
                  "--eqr_height", str(h), "--frame_count", str(count), "--device", "cpu"])
    log(f"[17 preview] preview.main on the CPU, {w}x{h}: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(rec_dir)
    return dirs[0], cpu_dir


def phase_compare(card_dir, cpu_dir):
    """compare.main on the preview JPEGs: the card's directory against
    itself and against the CPU's (--min_psnr_db 40 exits non-zero below)."""
    from surround360_tpu_torch.cli import compare

    t0 = time.perf_counter()
    same = compare.main(["--dir_a", card_dir, "--dir_b", card_dir])
    if same["psnr_min_db"] <= 100.0:
        raise AssertionError(f"a directory against itself: {same['psnr_min_db']} dB")
    rep = compare.main(["--dir_a", card_dir, "--dir_b", cpu_dir, "--min_psnr_db",
                        str(PSNR_MIN)])
    log(f"[18 compare] compare.main, {rep['frames']} JPEGs, card vs itself: min "
        f"{same['psnr_min_db']:.1f} dB; card vs CPU: mean {rep['psnr_mean_db']:.2f} dB, "
        f"min {rep['psnr_min_db']:.2f} dB (--min_psnr_db {PSNR_MIN}); "
        f"{time.perf_counter() - t0:.1f} s")


def calibration_environment(direction, cell_degrees=CELL_DEGREES):
    """A corner-rich, aperiodic scene for the matcher: grey cells on the
    faces of a cube around the rig, at two sizes (``cell_degrees`` and
    2.7 times smaller), each cell's level hashed from its index. RGB
    (..., 3) float32 of unit directions (..., 3)."""
    a = np.abs(direction)
    face = np.argmax(a, axis=-1)
    major = np.take_along_axis(a, face[..., None], -1)[..., 0]
    sign = np.take_along_axis(direction, face[..., None], -1)[..., 0] > 0
    u = np.where(face == 0, direction[..., 1], direction[..., 0]) / major
    v = np.where(face == 2, direction[..., 1], direction[..., 2]) / major
    face_id = face * 2 + sign
    level = np.zeros(u.shape)
    for weight, degrees, salt in ((0.6, cell_degrees, 1), (0.4, cell_degrees / 2.7, 2)):
        size = np.tan(np.deg2rad(degrees))
        i = np.floor((u + 1) / size).astype(np.int64) + 100000 * face_id
        j = np.floor((v + 1) / size).astype(np.int64)
        h = (i * 73856093) ^ (j * 19349663) ^ (salt * 83492791)
        h = (h ^ (h >> 13)) * 1274126177
        h = h ^ (h >> 16)
        level += weight * (h & 0xFFFF) / 65535.0
    grey = (0.1 + 0.8 * level).astype(np.float32)
    return np.stack([grey] * 3, axis=-1)


def sinusoid_environment(direction):
    """tests/test_matches.py's scene: three checker sinusoids of unrelated
    frequencies, aperiodic enough that ORB's matches do not alias."""
    from surround360_tpu_torch.capture import checker_sinusoid_environment

    return (0.5 * checker_sinusoid_environment(direction, sharpness=23.7)
            + 0.3 * checker_sinusoid_environment(direction, sharpness=57.1)
            + 0.2 * checker_sinusoid_environment(direction, sharpness=118.9))


def reference_loop_rig():
    """tests/test_matches.py's rig: the 6-camera 120 deg ring at 0.25
    scale (512 px)."""
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    return make_ring_rig(num_side_cameras=6, side_fov_degrees=120.0).rescaled(0.25)


def ring_pairs(rig, views, matcher):
    """Side cameras cam1..cam6 matched with their ring neighbour, as the
    reference's loop does (pairs with fewer than 8 matches left out):
    (keypoints, matches, right, wrong), a match being right within 2 px of
    the true correspondence."""
    from surround360_tpu_torch.geometry import camera as C

    keypoints, matches, right, wrong = {}, [], 0, 0
    for i in range(1, 7):
        id_a, id_b = f"cam{i}", f"cam{1 + i % 6}"
        ia, ib = rig.ids.index(id_a), rig.ids.index(id_b)
        pa, pb = matcher(views[ia][:3], views[ib][:3])
        if len(pa):
            far = C.pixel_to_rig_near_infinity(rig.cameras[ia], pa)
            err = np.linalg.norm(C.world_to_pixel(rig.cameras[ib], far) - pb, axis=1)
            right += int((err < 2).sum())
            wrong += int((err >= 2).sum())
        if len(pa) < 8:
            continue
        base_a = len(keypoints.setdefault(id_a, np.zeros((0, 2))))
        base_b = len(keypoints.setdefault(id_b, np.zeros((0, 2))))
        keypoints[id_a] = np.concatenate([keypoints[id_a], pa])
        keypoints[id_b] = np.concatenate([keypoints[id_b], pb])
        matches.append((id_a, id_b, np.stack(
            [base_a + np.arange(len(pa)), base_b + np.arange(len(pb))], axis=1)))
    return keypoints, matches, right, wrong


def match_config():
    """tests/test_matches.py's config: intrinsics locked, as its sparse
    ring graph cannot hold them."""
    from surround360_tpu_torch.calib.geometric import GeometricCalibrationConfig

    return GeometricCalibrationConfig(passes=4, lm_iterations=10, outlier_factor=3.0,
                                      lock_focal=True, lock_distortion=True,
                                      lock_principal=True)


def recover(rig, keypoints, matches, device="cpu"):
    """The reference's match -> calibrate loop on the traces, its 0.004 rad
    perturbation (principal point kept) and locked config: (traces, report
    before, report after, refined rig)."""
    from surround360_tpu_torch.calib.geometric import (
        calibrate_geometric, perturb_rig, reprojection_errors, reprojection_report,
        triangulate_points)
    from surround360_tpu_torch.calib.matches import assemble_traces

    obs = assemble_traces(keypoints, matches, {f"cam{i}": rig.ids.index(f"cam{i}")
                                               for i in range(1, 7)})
    bad = perturb_rig(rig, rotation_amount=MATCH_PERTURB, principal_amount=0.0)
    before = reprojection_report(
        reprojection_errors(bad, obs, triangulate_points(bad, obs, device), device))
    refined, after = calibrate_geometric(bad, obs, match_config(), device=device)
    return obs.num_points, before, after, refined


def _render_views(rig, env_fn):
    """render_camera_views, one camera a thread (numpy releases the GIL)."""
    from surround360_tpu_torch.capture import render_camera_views
    from surround360_tpu_torch.geometry.rig import Rig

    def one(i):
        return render_camera_views(
            Rig([rig.cameras[i]], [rig.ids[i]], ["side camera"]), env_fn=env_fn)[0]

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(len(rig.cameras))))


def _rig_fields_max_abs(a, b) -> float:
    return max(float(np.abs(np.asarray(getattr(ca, f), np.float64)
                            - np.asarray(getattr(cb, f), np.float64)).max())
               for ca, cb in zip(a.cameras, b.cameras) for f in ca._fields)


def _min_forward_dot(truth, rig) -> float:
    return min(float(np.dot(np.asarray(t.forward), np.asarray(r.forward)))
               for t, r in zip(truth.cameras, rig.cameras))


_PASS_LINE = re.compile(r"pass (\d+): (\{.*\}) lm_iterations (\d+) seconds ([\d.]+)")


def _calibrate_cli(argv):
    """calibrate.main(argv) with its per-pass lines captured: (seconds,
    [(report, LM iterations, seconds) a pass])."""
    from surround360_tpu_torch.cli import calibrate

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        calibrate.main(argv)
    wall = time.perf_counter() - t0
    passes = [(ast.literal_eval(m.group(2)), int(m.group(3)), float(m.group(4)))
              for m in map(_PASS_LINE.match, buf.getvalue().splitlines()) if m]
    return wall, passes


def phase_calib_unit(root, rig, device_name="cuda", points=CALIB_POINTS,
                     passes=CALIB_PASSES):
    """19a: calibrate geometric --unit_test on the rig: the refined rig
    against the truth with tests/test_calib_geometric.py's bounds."""
    import torch

    from surround360_tpu_torch.calib.geometric import (
        generate_artificial_points, perturb_rig, reprojection_errors,
        reprojection_report, triangulate_points)
    from surround360_tpu_torch.geometry.rig import load_rig, save_rig

    os.makedirs(root, exist_ok=True)
    rig_json = os.path.join(root, "rig.json")
    save_rig(rig_json, rig)
    truth = load_rig(rig_json)
    out = os.path.join(root, "unit_refined.json")
    on_card = device_name.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    wall, lines = _calibrate_cli([
        "geometric", "--unit_test", "--num_points", str(points), "--pass_count",
        str(passes), "--perturb_rotation", str(CALIB_PERTURB), "--rig_json", rig_json,
        "--output_json", out, "--device", device_name])
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    if len(lines) != passes:
        raise AssertionError(f"calibrate printed {len(lines)} pass lines, want {passes}")
    obs, _ = generate_artificial_points(truth, points)
    bad = perturb_rig(truth, rotation_amount=CALIB_PERTURB)
    before = reprojection_report(reprojection_errors(
        bad, obs, triangulate_points(bad, obs, device_name), device_name))
    after = lines[-1][0]
    dot = _min_forward_dot(truth, load_rig(out))
    iters = sum(n for _, n, _ in lines)
    secs = sum(t for _, _, t in lines)
    log(f"[19 geometric] calibrate geometric --unit_test on {device_name}: "
        f"{len(rig.cameras)} cameras, {obs.num_points} points, {len(obs.cam_idx)} "
        f"observations, {passes} passes in {wall:.3f} s (CLI; passes {secs:.3f} s): "
        f"{secs / passes:.3f} s a pass, {iters} LM iterations, {1e3 * secs / iters:.1f} ms "
        f"an iteration (cull, solve tries and report included); peak {peak:.3f} GiB; "
        f"a pass (iterations, s): " + ", ".join(f"{n} {t:.3f}" for _, n, t in lines))
    log(f"[19 geometric]   RMSE perturbed {before['rmse']:.4f} px -> refined "
        f"{after['rmse']:.3g} px (< 0.15 x), observations kept {after['count']}; "
        f"min forward dot vs truth {dot:.9f} (> 0.99999)")
    if not after["rmse"] < 0.15 * before["rmse"]:
        raise AssertionError(f"refined RMSE {after['rmse']} vs perturbed {before['rmse']}")
    if not dot > 0.99999:
        raise AssertionError(f"refined forward dot {dot}")


def phase_calib_noise(rig, device_name="cuda", points=NOISE_POINTS):
    """19b: the library with 0.5 px noise on the card and on the CPU
    (tests/test_calib_geometric.py's noise-floor case at the rig's size)."""
    from surround360_tpu_torch.calib.geometric import (
        GeometricCalibrationConfig, _rig_to_params, calibrate_geometric,
        generate_artificial_points, perturb_rig)

    obs, _ = generate_artificial_points(rig, points, seed=5, noise_px=0.5)
    bad = perturb_rig(rig, rotation_amount=0.003)
    cfg = GeometricCalibrationConfig(passes=NOISE_PASSES)
    rows, info = [], []
    for dev in (device_name, "cpu"):
        t0 = time.perf_counter()
        refined, rep = calibrate_geometric(bad, obs, cfg, device=dev)
        info.append(f"{dev} {time.perf_counter() - t0:.3f} s, RMSE {rep['rmse']:.4f} px")
        if not 0.2 < rep["rmse"] < 1.5:
            raise AssertionError(f"noise floor on {dev}: {rep}")
        rows.append(_rig_to_params(refined))
    rot = float(np.abs(rows[0][:, 3:6] - rows[1][:, 3:6]).max())
    px = float(np.abs(rows[0][:, 6:9] - rows[1][:, 6:9]).max())
    log(f"[19 geometric] library, {points} points ({len(obs.cam_idx)} observations), "
        f"0.5 px noise, {NOISE_PASSES} passes: " + "; ".join(info)
        + f" (0.2-1.5); card vs CPU rows: rotation {rot:.3g} rad (<= {NOISE_ROT_TOL}), "
        f"principal and focal {px:.3g} px (<= {NOISE_PX_TOL})")
    if rot > NOISE_ROT_TOL or px > NOISE_PX_TOL:
        raise AssertionError(f"card vs CPU: rotation {rot}, px {px}")


def write_colmap_db(path, ids, keypoints, matches):
    """A COLMAP-schema sqlite file of a match graph: images (image_id =
    rig index + 1, name '<id>.png'), keypoints (float32 x, y, scale 1,
    orientation 0), matches (uint32 index pairs, pair_id = id1 x
    2147483647 + id2)."""
    image_id = {cid: i + 1 for i, cid in enumerate(ids)}
    conn = sqlite3.connect(path)
    try:
        conn.executescript(
            "CREATE TABLE images (image_id INTEGER PRIMARY KEY, camera_id INTEGER, "
            "name TEXT); CREATE TABLE keypoints (image_id INTEGER PRIMARY KEY, rows "
            "INTEGER, cols INTEGER, data BLOB); CREATE TABLE matches (pair_id INTEGER "
            "PRIMARY KEY, rows INTEGER, cols INTEGER, data BLOB);")
        for cid in ids:
            conn.execute("INSERT INTO images VALUES (?, ?, ?)",
                         (image_id[cid], image_id[cid], f"{cid}.png"))
            kp = np.zeros((len(keypoints.get(cid, ())), 4), np.float32)
            if len(kp):
                kp[:, :2] = keypoints[cid]
                kp[:, 2] = 1.0
            conn.execute("INSERT INTO keypoints VALUES (?, ?, 4, ?)",
                         (image_id[cid], len(kp), kp.tobytes()))
        for id_a, id_b, idx in matches:
            pair = image_id[id_a] * 2147483647 + image_id[id_b]
            conn.execute("INSERT INTO matches VALUES (?, ?, 2, ?)",
                         (pair, len(idx), np.asarray(idx, np.uint32).tobytes()))
        conn.commit()
    finally:
        conn.close()


def _orb_card_vs_cpu(grey_u8, device_name):
    """detect_and_compute on ``device_name`` and on the CPU of one uint8
    image: (keypoints, card ms, CPU s); raises unless positions,
    descriptors and levels are equal bit for bit."""
    import torch

    from surround360_tpu_torch.calib.orb import detect_and_compute

    card = detect_and_compute(grey_u8.to(device_name))
    t0 = time.perf_counter()
    cpu = detect_and_compute(grey_u8.cpu())
    cpu_s = time.perf_counter() - t0
    on_card = device_name.startswith("cuda")
    ms = cuda_ms(lambda: detect_and_compute(grey_u8.to(device_name)), reps=3) if on_card \
        else 1e3 * cpu_s
    for name, a, b in zip(card._fields, card, cpu):
        if a.shape != b.shape or not torch.equal(a.cpu(), b):
            raise AssertionError(f"detect_and_compute {name}: {device_name} != CPU "
                                 f"({tuple(a.shape)} vs {tuple(b.shape)})")
    return len(cpu.points), ms, cpu_s


def phase_calib_match(root, rig, device_name="cuda"):
    """19c: the built-in matcher (OpenCV's ORB, stage for stage) on the
    rig's simulator views, card against CPU, the library gate of
    tests/test_matches.py on its traces, the reference's own loop on its
    512 px sinusoid scene, and the CLI's two routes (--frames_dir, and
    --matches_json through a COLMAP database) each against the library."""
    import torch

    from surround360_tpu_torch.calib.geometric import (
        GeometricCalibrationConfig, calibrate_geometric, perturb_rig,
        reprojection_errors, reprojection_report, triangulate_points)
    from surround360_tpu_torch.calib.matches import (
        assemble_traces, colmap_db_to_matches_json, load_matches_json, match_keypoints)
    from surround360_tpu_torch.calib.orb import detect_and_compute, to_gray8
    from surround360_tpu_torch.cli.calibrate import match_frames
    from surround360_tpu_torch.cli.common import read_image_rgba, write_image
    from surround360_tpu_torch.geometry.rig import Rig, load_rig, save_rig

    width = float(rig.cameras[1].resolution[0])
    cell = CELL_DEGREES * 2048.0 / width  # the same cells in pixels at any size
    frames = os.path.join(root, "frames")
    os.makedirs(frames, exist_ok=True)
    t0 = time.perf_counter()
    views = _render_views(rig, lambda d: calibration_environment(d, cell))
    render_s = time.perf_counter() - t0
    for cid, view in zip(rig.ids, views):
        write_image(os.path.join(frames, f"{cid}.png"), view)
    del views

    # the matcher on tests/test_matches.py's sinusoid scene, one side camera
    side = _render_views(Rig([rig.cameras[1]], [rig.ids[1]], ["side camera"]),
                         sinusoid_environment)[0]
    sinusoid_kp = len(detect_and_compute(to_gray8(side[:3], device_name)).points)

    bad = perturb_rig(rig, rotation_amount=MATCH_PERTURB, principal_amount=0.0)
    bad_json = os.path.join(root, "perturbed.json")
    save_rig(bad_json, bad)
    bad = load_rig(bad_json)
    images = {cid: read_image_rgba(os.path.join(frames, f"{cid}.png")) for cid in rig.ids}
    same = []
    for cid in rig.ids[1:3]:
        n, ms, cpu_s = _orb_card_vs_cpu(to_gray8(images[cid][:3], "cpu"), device_name)
        same.append(f"{cid} {n} keypoints, {ms:.2f} ms ({device_name}) vs {cpu_s:.3f} s (CPU)")
    log(f"[19 geometric] detect_and_compute {device_name} == CPU bit for bit (positions, "
        f"descriptors, levels) at {int(width)} px: " + "; ".join(same))
    on_card = device_name.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    keypoints, matches = match_frames(bad, images, device_name)
    match_s = time.perf_counter() - t0
    del images
    obs = assemble_traces(keypoints, matches, {cid: i for i, cid in enumerate(rig.ids)})
    n_matches = sum(len(m[2]) for m in matches)
    log(f"[19 geometric] matcher on {device_name}: {len(rig.cameras)} views of "
        f"{int(width)} px rendered in {render_s:.1f} s (host, 8 threads); "
        f"{len(matches)} camera pairs matched (overlap >= 0.05, >= 8 matches) in "
        f"{match_s:.3f} s ({1e3 * match_s / max(len(matches), 1):.1f} ms a pair, both "
        f"detections included; the learned-table matcher {ORB_PAIR_MS_LEARNED} ms), "
        f"{n_matches} matches, "
        f"{obs.num_points} traces, {len(obs.cam_idx)} observations; keypoints appended "
        "per image: " + ", ".join(f"{cid} {len(kp)}" for cid, kp in keypoints.items())
        + f"; keypoints on the sinusoid scene of tests/test_matches.py at this size "
        f"({rig.ids[1]}): {sinusoid_kp}")

    before = reprojection_report(reprojection_errors(
        bad, obs, triangulate_points(bad, obs, device_name), device_name))
    t0 = time.perf_counter()
    refined, after = calibrate_geometric(bad, obs, match_config(), device=device_name)
    solve_s = time.perf_counter() - t0
    dot = _min_forward_dot(rig, refined)
    log(f"[19 geometric]   library (tests/test_matches.py's config) in {solve_s:.3f} s: "
        f"median {before['median']:.3f} -> {after['median']:.4f} px (< 0.7 x), "
        f"observations kept {after['count']}; min forward dot vs truth {dot:.7f} (> 0.999)")
    if not after["median"] < 0.7 * before["median"] or not dot > 0.999:
        raise AssertionError(f"matcher loop: {before} -> {after}, dot {dot}")

    # the reference's loop on its own scene (tests/test_matches.py)
    small = reference_loop_rig()
    small_views = _render_views(small, sinusoid_environment)
    for cid in (f"cam{i}" for i in range(1, 7)):
        _orb_card_vs_cpu(to_gray8(small_views[small.ids.index(cid)][:3], "cpu"), device_name)
    t0 = time.perf_counter()
    kp_small, m_small, right, wrong = ring_pairs(
        small, small_views, lambda a, b: match_keypoints(a, b, device=device_name))
    pairs_s = time.perf_counter() - t0
    traces, before, after, refined = recover(small, kp_small, m_small, device_name)
    dot = _min_forward_dot(small, refined)
    log(f"[19 geometric] the reference's loop on its sinusoid scene ({len(small.cameras)} "
        f"cameras, {int(small.cameras[1].resolution[0])} px; detect_and_compute "
        f"{device_name} == CPU on cam1..cam6): 6 ring pairs in {pairs_s:.3f} s, {right} "
        f"right / {wrong} wrong matches, {traces} traces; median {before['median']:.3f} -> "
        f"{after['median']:.4f} px (ratio {after['median'] / before['median']:.4f} < 0.7), "
        f"min forward dot {dot:.6f} (> 0.999)")
    if not (traces > 30 and after["median"] < 0.7 * before["median"] and dot > 0.999):
        raise AssertionError(f"reference loop: {traces} traces, {before} -> {after}, dot {dot}")

    db = os.path.join(root, "features.db")
    if os.path.exists(db):
        os.remove(db)
    write_colmap_db(db, rig.ids, keypoints, matches)
    matches_json = os.path.join(root, "matches.json")
    colmap_db_to_matches_json(db, matches_json)
    out_json = os.path.join(root, "refined_json.json")
    json_s, json_lines = _calibrate_cli([
        "geometric", "--rig_json", bad_json, "--matches_json", matches_json,
        "--output_json", out_json, "--device", device_name])
    out_frames = os.path.join(root, "refined_frames.json")
    frames_s, frames_lines = _calibrate_cli([
        "geometric", "--rig_json", bad_json, "--frames_dir", frames,
        "--output_json", out_frames, "--device", device_name])
    # each route against the library on its own positions (the CLI's config),
    # and against the reference loop's gate on its own traces
    json_kp, json_matches = load_matches_json(matches_json)
    routes = {
        "--frames_dir": (out_frames, frames_lines, obs),
        "--matches_json": (out_json, json_lines, assemble_traces(
            json_kp, json_matches, {n: rig.ids.index(n[:-len(".png")]) for n in json_kp})),
    }
    gaps, medians = {}, {}
    for route, (out, lines, route_obs) in routes.items():
        lib, _ = calibrate_geometric(bad, route_obs, GeometricCalibrationConfig(),
                                     device=device_name)
        gaps[route] = _rig_fields_max_abs(load_rig(out), lib)
        perturbed = reprojection_report(reprojection_errors(
            bad, route_obs, triangulate_points(bad, route_obs, device_name), device_name))
        medians[route] = (perturbed["median"], lines[-1][0]["median"])
    pos_gap = max(float(np.abs(json_kp[f"{cid}.png"] - kp).max()) for cid, kp in keypoints.items())
    fields = {f: max(float(np.abs(np.asarray(getattr(a, f), np.float64)
                                  - np.asarray(getattr(b, f), np.float64)).max())
                     for a, b in zip(load_rig(out_frames).cameras, load_rig(out_json).cameras))
              for f in ("rotation", "principal", "focal", "distortion")}
    log(f"[19 geometric]   CLI --frames_dir {frames_s:.3f} s (matching included); "
        f"--matches_json from a COLMAP database {json_s:.3f} s; each vs the library on its "
        "own positions: " + ", ".join(f"{r} {g:.3g}" for r, g in gaps.items())
        + f" (<= {CLI_AGREE}); median perturbed -> refined: "
        + ", ".join(f"{r} {a:.3f} -> {b:.4f} px" for r, (a, b) in medians.items())
        + f" (< 0.7 x); positions through the JSON strings move by <= {pos_gap:.3g} px "
        f"(< {ROUTE_POSITIONS:.3g}, one float32 ulp at 2048 px); the two refined rigs "
        "differ by " + ", ".join(f"{f} {v:.3g}" for f, v in fields.items())
        + " (not bounded: the pairwise traces leave focal and principal point free to "
        "drift, and the culls between passes amplify the positions' last bits)")
    if (max(gaps.values()) > CLI_AGREE or pos_gap >= ROUTE_POSITIONS
            or any(not b < 0.7 * a for a, b in medians.values())):
        raise AssertionError(f"CLI routes: {gaps}, medians {medians}, positions {pos_gap}")


def write_vignetting_sweep(dest, size=SWEEP_SIZE, grid=SWEEP_GRID, seed=0):
    """grid x grid 16-bit grey PNGs of a bright grey square on a dim
    background under the separable Bezier rolloff ROLLOFF_X x ROLLOFF_Y,
    with noise. Returns (target centres (N, 2), the planes as the CLI
    reads them)."""
    from surround360_tpu_torch.cli.common import write_png
    from surround360_tpu_torch.utils.math_util import bezier_curve_batch

    os.makedirs(dest, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(size) / size
    rolloff = np.outer(bezier_curve_batch(np.asarray(ROLLOFF_Y), t),
                       bezier_curve_batch(np.asarray(ROLLOFF_X), t))
    margin = size // 20
    pos = np.rint(np.linspace(margin, size - 1 - margin, grid)).astype(int)
    centres = [(x, y) for y in pos for x in pos]
    planes = []

    def one(k):
        x, y = centres[k]
        img = np.full((size, size), 0.05)
        img[y - SWEEP_HALF : y + SWEEP_HALF + 1, x - SWEEP_HALF : x + SWEEP_HALF + 1] += SWEEP_TARGET
        img = img * rolloff + rng_k[k].standard_normal((size, size)) * SWEEP_NOISE
        u16 = np.clip(np.rint(img * 65535.0), 0, 65535).astype(np.uint16)
        write_png(os.path.join(dest, f"{k:03d}.png"), u16[..., None])
        return u16.astype(np.float32) / 65535.0

    rng_k = [np.random.default_rng(s) for s in rng.integers(0, 2**31, len(centres))]
    with ThreadPoolExecutor(8) as pool:
        planes = list(pool.map(one, range(len(centres))))
    return np.asarray(centres, np.float64), planes


def phase_vignetting(root, device_name="cuda", size=SWEEP_SIZE, grid=SWEEP_GRID):
    """20: a vignetting sweep through the library on the card and the CPU
    (seconds), then calibrate vignetting on both: locations at the targets,
    gain x surface flat, the card's ISP JSON equal to the CPU's."""
    import torch

    from surround360_tpu_torch.calib.vignetting import (
        acquire_vignetting_samples, fit_vignetting)
    from surround360_tpu_torch.cli import calibrate
    from surround360_tpu_torch.utils.math_util import bezier_curve_batch

    sweep = os.path.join(root, "sweep")
    shutil.rmtree(sweep, ignore_errors=True)
    t0 = time.perf_counter()
    truth, planes = write_vignetting_sweep(sweep, size, grid)
    write_s = time.perf_counter() - t0
    info = []
    for dev in (device_name, "cpu"):
        t0 = time.perf_counter()
        locs, intensities = acquire_vignetting_samples(planes, device=dev)
        acq_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit = fit_vignetting(locs, intensities, (size, size), device=dev)
        fit_s = time.perf_counter() - t0
        off = float(np.abs(locs - truth).max())
        ts = np.linspace(0.0, (size - 1) / size, 33)
        flat = max(float(np.std(p) / np.mean(p)) for p in (
            bezier_curve_batch(fit.rolloff_h[:, c], ts) * bezier_curve_batch(fit.bezier_x[c], ts)
            for c in range(3)))
        info.append(f"{dev}: acquisition {1e3 * acq_s / len(planes):.2f} ms a frame, fit "
                    f"{fit_s:.3f} s, rms residual {fit.rms_residual:.2e}, locations off the "
                    f"targets by <= {off:g} px, gain x surface spread {flat:.2e}")
        if off > 1 or flat >= 0.01:
            raise AssertionError(f"vignetting on {dev}: locations off by {off}, spread {flat}")
    del planes
    rolloffs = []
    for dev in (device_name, "cpu"):
        out = os.path.join(root, f"isp_{dev.split(':')[0]}.json")
        t0 = time.perf_counter()
        calibrate.main(["vignetting", "--sweep_dir", sweep, "--output_isp_json", out,
                        "--device", dev])
        info.append(f"CLI on {dev} {time.perf_counter() - t0:.3f} s")
        with open(out) as f:
            isp = json.load(f)["CameraIsp"]
        rolloffs.append(np.asarray([isp["vignetteRollOffH"], isp["vignetteRollOffV"]]))
    diff = float(np.abs(rolloffs[0] - rolloffs[1]).max())
    log(f"[20 vignetting] {len(truth)} frames {size}x{size} 16-bit written in {write_s:.1f} s; "
        + "; ".join(info) + f"; the card's ISP JSON rolloff vs the CPU's max-abs {diff:.3g} "
        f"(<= {ROLLOFF_CPU_TOL})")
    if diff > ROLLOFF_CPU_TOL:
        raise AssertionError(f"ISP JSON rolloff card vs CPU: {diff}")


def lab_to_rgb(lab, illuminant="D50"):
    """Linear RGB of CIELAB values: the inverse of calib.color.rgb_to_lab
    (tests/test_calib_color.py's)."""
    from surround360_tpu_torch.calib.color import _RGB2XYZ, _WHITE

    lab = np.asarray(lab, dtype=np.float64)
    y = (lab[..., 0] + 16.0) / 116.0
    x = lab[..., 1] / 500.0 + y
    z = y - lab[..., 2] / 200.0
    f = np.stack([x, y, z], axis=-1)
    t = np.where(f**3 > 0.008856, f**3, (f - 16.0 / 116.0) / 7.787)
    m = _RGB2XYZ[illuminant] / _WHITE[illuminant][:, None]
    return t @ np.linalg.inv(m).T


def chart_raw_colors(illuminant="D50"):
    """The 24 patches' raw colours as TestColorSolve._make_observations makes
    them: bl + (1 - bl) M^-1 rgb / s, with its M, its black level and a
    quadratic falloff s over the chart's columns and rows."""
    from surround360_tpu_torch.calib.color import LAB_MACBETH

    rgb = lab_to_rgb(LAB_MACBETH[illuminant], illuminant)
    bl = np.asarray(CHART_BL)
    u = np.tile(np.arange(6) / 5.0, 4)
    v = np.repeat(np.arange(4) / 3.0, 6)
    s = 1.0 - 0.15 * u * u - 0.1 * v * v
    return bl + (1.0 - bl) * (rgb @ np.linalg.inv(np.asarray(CHART_M)).T) / s[:, None]


def _homography(src, dst):
    """The 3 x 3 map of four points onto four (getPerspectiveTransform)."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    return np.append(np.linalg.solve(np.asarray(a, float), np.asarray(b, float)), 1).reshape(3, 3)


def render_chart(colors, size=CHART_SIZE, scale=CHART_SCALE, rotation_deg=0.0,
                 perspective=0.0, noise=0.0, vignette=False, seed=4):
    """tests/test_calib_color.py's chart without OpenCV: the 24 colours on a
    0.02 frame over a 0.35 surround, its geometry (36 px patches, 10 px
    separators) times ``scale``, centred in a size x size frame, rotated
    about the centre, then the fixture's perspective, bilinear
    (torch.grid_sample on the host); then the radial vignette and the noise.
    Returns ((3, H, W) float32, the patch centres (24, 2) after the warps)."""
    import torch

    H = W = size
    rng = np.random.default_rng(seed)
    img = np.full((H, W, 3), 0.35, np.float32)
    pw, gap = round(36 * scale), round(10 * scale)
    cw, ch = 6 * pw + 7 * gap, 4 * pw + 5 * gap
    x0, y0 = (W - cw) // 2, (H - ch) // 2
    img[y0:y0 + ch, x0:x0 + cw] = 0.02
    truth = []
    for r in range(4):
        for c in range(6):
            x, y = x0 + gap + c * (pw + gap), y0 + gap + r * (pw + gap)
            img[y:y + pw, x:x + pw] = colors[r * 6 + c]
            truth.append([x + pw / 2, y + pw / 2])
    a = np.radians(rotation_deg)
    al, be, cx, cy = np.cos(a), np.sin(a), W / 2, H / 2
    A = np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy],
                  [0, 0, 1]])
    sq = np.array([[0, 0], [W, 0], [W, H], [0, H]], float)
    p = perspective
    P = _homography(sq, sq + [[p * W, 0], [-p * W, p * H * 0.3], [p * W, 0], [-p * W, 0]])
    Hm = P @ A
    t = np.concatenate([np.asarray(truth), np.ones((24, 1))], axis=1) @ Hm.T
    truth = t[:, :2] / t[:, 2:]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    src = np.stack([xx, yy, np.ones_like(xx)], axis=-1) @ np.linalg.inv(Hm).T
    sx, sy = src[..., 0] / src[..., 2], src[..., 1] / src[..., 2]
    grid = torch.from_numpy(np.stack([2 * sx / (W - 1) - 1, 2 * sy / (H - 1) - 1],
                                     axis=-1)[None].astype(np.float32))
    chw = torch.from_numpy(np.moveaxis(img, -1, 0) - np.float32(0.35))[None]
    out = torch.nn.functional.grid_sample(chw, grid, align_corners=True)[0].numpy() + 0.35
    if vignette:
        rad = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2) / (W / 2) ** 2
        out = out * (1.0 - 0.35 * rad)[None]
    if noise:
        out = np.clip(out + rng.normal(0, noise, out.shape), 0, 1)
    return out.astype(np.float32), truth


def write_color_charts(dest, cameras=CHART_CAMERAS, size=CHART_SIZE):
    """One 16-bit PNG chart a camera (``cam<i>.png``): rotations over
    -7..7 degrees, perspective 0..0.04, the vignette and noise 0.01, each
    camera its own seed. Returns {serial: truth centres}."""
    from surround360_tpu_torch.cli.common import write_image

    os.makedirs(dest, exist_ok=True)
    colors = chart_raw_colors()

    def one(i):
        img, truth = render_chart(
            colors, size, CHART_SCALE, rotation_deg=-7.0 + 14.0 * i / max(cameras - 1, 1),
            perspective=CHART_PERSPECTIVE * (i % 5) / 4, noise=CHART_NOISE, vignette=True,
            seed=100 + i)
        write_image(os.path.join(dest, f"cam{i}.png"), img, bit_depth=16)
        return f"cam{i}", truth

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, range(cameras)))


def phase_color(root, device_name="cuda", size=CHART_SIZE, cameras=CHART_CAMERAS):
    """21: color calibration of ``cameras`` charts of size x size: the
    library on the card and the CPU (detection ms a camera split into the
    pixel stages, the components and the contours; the solve's seconds;
    24 patches within 5 px of the truth, the black level within 0.02, WB x
    CCM mapping grey to grey within 0.02), the CLI on both (seconds; the
    card's ISP JSONs equal to the CPU's within 1e-9; the corrected medians'
    mean DeltaE), and one chart at 1.0x, where the reference's detector
    also takes the chart's outline: 24 patches and a solve."""
    import torch

    from surround360_tpu_torch.calib.color import (
        delta_e_report, detect_color_chart, solve_isp_color_params)
    from surround360_tpu_torch.cli import calibrate
    from surround360_tpu_torch.cli.common import read_image_rgba

    charts = os.path.join(root, "charts")
    shutil.rmtree(charts, ignore_errors=True)
    t0 = time.perf_counter()
    truths = write_color_charts(charts, cameras, size)
    write_s = time.perf_counter() - t0
    M, bl_true = np.asarray(CHART_M), np.asarray(CHART_BL)
    grey_in = np.linalg.inv(M) @ np.ones(3)
    images = {s: read_image_rgba(os.path.join(charts, s + ".png"))[:3] for s in truths}
    if device_name != "cpu":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    info = []
    for dev in (device_name, "cpu"):
        stages = {"pixel": 0.0, "components": 0.0, "contours": 0.0}
        detect_s = solve_s = 0.0
        worst_c = worst_bl = worst_grey = 0.0
        de = []
        for serial, img in images.items():
            st = {}
            t0 = time.perf_counter()
            cents, meds = detect_color_chart(img, device=dev, stage_seconds=st)
            detect_s += time.perf_counter() - t0
            for k in stages:
                stages[k] += st[k]
            if len(cents) != 24:
                raise AssertionError(f"{serial} on {dev}: {len(cents)} patches")
            worst_c = max(worst_c, float(np.abs(cents - truths[serial]).max()))
            t0 = time.perf_counter()
            res = solve_isp_color_params(meds, cents, device=dev)
            solve_s += time.perf_counter() - t0
            worst_bl = max(worst_bl, float(np.abs(res.black_level - bl_true).max()))
            grey = res.ccm @ (res.white_balance * grey_in)
            worst_grey = max(worst_grey, float(np.abs(grey / grey.mean() - 1).max()))
            corrected = ((meds - res.black_level) / (1 - res.black_level)
                         * res.white_balance) @ res.ccm.T
            de.append(delta_e_report(corrected)["mean"])
        n = len(images)
        info.append(
            f"{dev}: detection {1e3 * detect_s / n:.1f} ms a camera (pixel stages "
            f"{1e3 * stages['pixel'] / n:.1f}, components {1e3 * stages['components'] / n:.1f}"
            f", contours {1e3 * stages['contours'] / n:.1f}), solve {solve_s / n:.3f} s a "
            f"camera; centroids <= {worst_c:.3f} px off, black level <= {worst_bl:.2e} off, "
            f"grey -> grey within {worst_grey:.2e}, corrected mean DeltaE "
            f"{np.mean(de):.3f} (max over cameras {np.max(de):.3f})")
        if worst_c > CHART_CENT_TOL or worst_bl > BL_TOL or worst_grey > GREY_TOL:
            raise AssertionError(f"color calibration on {dev}: " + info[-1])
    peak = ((torch.cuda.max_memory_allocated() - base) / 2**30 if device_name != "cpu"
            else float("nan"))
    jsons = []
    for dev in (device_name, "cpu"):
        out = os.path.join(root, f"color_isp_{dev.split(':')[0]}")
        t0 = time.perf_counter()
        calibrate.main(["color", "--charts_dir", charts, "--output_isp_dir", out,
                        "--device", dev])
        info.append(f"CLI on {dev} {time.perf_counter() - t0:.3f} s")
        got = {}
        for s in truths:
            with open(os.path.join(out, s + ".json")) as f:
                isp = json.load(f)["CameraIsp"]
            # the black level as a fraction of full scale, as the solve has it
            full = (1 << isp["bitsPerPixel"]) - 1
            got[s] = np.concatenate([np.ravel(isp["blackLevel"]) / full] + [
                np.ravel(isp[k]) for k in ("whiteBalanceGain", "ccm")])
        jsons.append(got)
    diff = max(float(np.abs(jsons[0][s] - jsons[1][s]).max()) for s in truths)
    one, truth = render_chart(chart_raw_colors(), size, 1.0, rotation_deg=5.0,
                              noise=CHART_NOISE, seed=7)
    cents, meds = detect_color_chart(one, device=device_name)
    res = solve_isp_color_params(meds, cents, device=device_name)
    log(f"[21 color] {cameras} charts {size}x{size} at {CHART_SCALE}x written in "
        f"{write_s:.1f} s; " + "; ".join(info) + f"; the card's ISP JSONs vs the CPU's "
        f"max-abs {diff:.3g} (<= {COLOR_CPU_TOL}); peak {peak:.3f} GiB; the 1.0x chart: "
        f"{len(cents)} patches, <= {float(np.abs(cents - truth).max()):.3f} px off, "
        f"cost {res.final_cost:.4f}")
    if diff > COLOR_CPU_TOL or len(cents) != 24:
        raise AssertionError(f"color: card vs CPU {diff}, 1.0x chart {len(cents)} patches")


def phase_mesh(ctx, inputs, device, frames=MESH_FRAMES):
    """22: parallel/mesh.py at phase 4's context: make_render_mesh() over
    the visible cards, then virtual meshes of one device repeated 14 times
    at (data 2, ring 7), temporal, two steps chained through the returned
    states, and (data 1, ring 14); every output against a sequential
    render_frame chain (within 1e-4), s a frame of each, peak memory, and
    K1's launches of each mesh run."""
    import torch

    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.parallel import (
        make_render_mesh, shard_frame_batch, sharded_render_step)
    from surround360_tpu_torch.render.panorama import render_frame

    side, top, bottom = inputs
    gains = 0.8 + 0.4 * np.arange(frames) / max(frames - 1, 1)
    batch = torch.stack([torch.cat([side[:, :3] * float(g), side[:, 3:]], 1) for g in gains])
    tops, bottoms = top[None].expand((frames,) + top.shape), bottom[None].expand(
        (frames,) + bottom.shape)

    # the sequential chains: each data shard of 2 frames, continued once
    t0 = time.perf_counter()
    ref = {}
    for first in range(0, frames, 2):
        st = None
        for rep in range(2):
            for f in (first, first + 1):
                out, st = render_frame(ctx, batch[f], top, bottom, state=st,
                                       use_temporal=st is not None)
                ref[(rep, f)] = out["equirect"]
    _sync(device)
    seq_s = (time.perf_counter() - t0) / len(ref)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    meshes = [("make_render_mesh()", make_render_mesh() if device.type == "cuda"
               else make_render_mesh([device]), 2, 1)]
    meshes.append(("(2, 7)", make_render_mesh([device] * 14, data_parallel=2), frames, 2))
    meshes.append(("(1, 14)", make_render_mesh([device] * 14, data_parallel=1), 2, 1))
    info = []
    for name, mesh, F, steps in meshes:
        step, _ = sharded_render_step(ctx, mesh, use_temporal=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        state, err = None, 0.0
        sharded = shard_frame_batch(mesh, batch[:F])
        for rep in range(steps):
            out, state = step(sharded, tops[:F], bottoms[:F], state)
            for f in range(F):  # every mesh's data chunks are 2 frames
                err = max(err, float((out["equirect"][f] - ref[(rep, f)]).abs().max()))
        _sync(device)
        secs = (time.perf_counter() - t0) / (F * steps)
        info.append(f"{name} {mesh.shape} F={F} x {steps} step(s): {secs:.3f} s a frame, "
                    f"max-abs vs the chain {err:.3g}, K1 launches {launch_count(fw.K1)}, "
                    f"K3 {launch_count(fw.K3)}")
        if not err <= MESH_TOL:
            raise AssertionError(f"mesh {name}: {err} > {MESH_TOL}")
        if device.type == "cuda" and not launch_count(fw.K1):
            raise AssertionError(f"mesh {name} launched no K1")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
            else float("nan"))
    log(f"[22 mesh] {ctx.config.eqr_width}x{ctx.config.eqr_height}/eye "
        f"{ctx.config.side_flow_alg}: sequential chain {seq_s:.3f} s a frame; "
        + "; ".join(info) + f"; peak {peak:.2f} GiB (one card: the meshes' devices "
        "are one card repeated, so no multi-GPU rate is measured)")


def _bench(extra_env, device_name="cuda"):
    """``python -m surround360_tpu_torch.bench`` as a user runs it, in a
    subprocess with S360_BENCH_MEMSTATS=1: (its last stdout line, the
    subprocess's wall seconds, the peak-memory line, the kernel launches
    it counted from its frame 0 on)."""
    env = dict(os.environ, S360_BENCH_MEMSTATS="1", **extra_env)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "surround360_tpu_torch.bench",
                           "--device", device_name], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench {extra_env} exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if set(line) != BENCH_KEYS or not line["value"] > 0:
        raise AssertionError(f"bench {extra_env}: last line {line}")
    if line["vs_baseline"] != round(line["value"] / 30.0, 4):
        raise AssertionError(f"bench {extra_env}: vs_baseline of {line}")
    stats = [l for l in proc.stderr.splitlines() if l.startswith("# ")]
    peak = next((l[2:] for l in stats if l.startswith("# peak HBM")), "no peak (CPU)")
    launches = json.loads(next(l for l in stats if l.startswith("# kernel launches"))
                          .removeprefix("# kernel launches "))
    return line, wall, peak, launches


def _check_launches(what, launches):
    from surround360_tpu_torch.ops import fused_window as fw

    if not launches[fw.K1] or launches[fw.K2]:
        raise AssertionError(f"{what}: K1 must launch and K2 must not: {launches}")


def phase_bench_entries(calib_root, device_name="cuda"):
    """23: the bench at its defaults and in its legacy mode, the root
    entry's counterpart, and the TF32 repair, on the card; returns the
    kernel launches of the three rendering runs."""
    import torch

    from surround360_tpu_torch import graft_entry
    from surround360_tpu_torch.cli import common, raw2rgb
    from surround360_tpu_torch.cli.tiff import write_tiff
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.isp.pipeline import IspConfig
    from surround360_tpu_torch.ops import fused_window as fw

    if device_name.startswith("cuda"):
        torch.cuda.empty_cache()  # the subprocesses share the card
    runs = {}
    for name, env in (("6k", {}), ("legacy", {"S360_BENCH_PRESET": "off",
                                              "S360_BENCH_FRAMES": str(BENCH_LEGACY_FRAMES)})):
        line, wall, peak, launches = _bench(env, device_name)
        _check_launches(f"bench {name}", launches)
        runs[name] = launches
        log(f"[23 bench] {name}: {line['value']} frames/s ({1 / line['value']:.3f} s a "
            f"frame), vs_baseline {line['vs_baseline']}, {peak}, subprocess {wall:.1f} s, "
            f"launches {launches}; metric {line['metric']!r}")

    reset_launch_counts()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(device_name)
    out = fn(*args)
    _sync(out.device)
    entry_s = time.perf_counter() - t0
    if tuple(out.shape) != (3, 280, 280) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"graft entry: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        err, err14 = graft_entry.dryrun_multichip(8, device_name)
    dry_s = time.perf_counter() - t0
    runs["graft entry"] = {k: launch_count(k) for k in fw.KERNELS}
    _check_launches("graft entry", runs["graft entry"])
    if not (err < MESH_TOL and err14 < MESH_TOL):
        raise AssertionError(f"dryrun_multichip: {err}, {err14}")
    log(f"[23 entry] entry(): {tuple(out.shape)} finite in {entry_s:.2f} s; "
        f"{buf.getvalue().strip()} ({dry_s:.1f} s); launches {runs['graft entry']}")

    # TF32: calibrate vignetting alone in a fresh process that sets no flag
    # itself, on phase 20's sweep, against phase 20's card JSON
    out_json = os.path.join(calib_root, "isp_fresh.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; assert torch.backends.cudnn.allow_tf32; "
         "from surround360_tpu_torch.cli import calibrate; calibrate.main(['vignetting', "
         f"'--sweep_dir', {os.path.join(calib_root, 'sweep')!r}, '--output_isp_json', "
         f"{out_json!r}, '--device', {device_name!r}])"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fresh calibrate vignetting: {proc.stderr[-3000:]}")
    rolloffs = []
    for path in (out_json, os.path.join(calib_root, f"isp_{device_name.split(':')[0]}.json")):
        with open(path) as f:
            isp = json.load(f)["CameraIsp"]
        rolloffs.append(np.asarray([isp["vignetteRollOffH"], isp["vignetteRollOffV"]]))
    diff = float(np.abs(rolloffs[0] - rolloffs[1]).max())
    if not diff <= ROLLOFF_CPU_TOL:
        raise AssertionError(f"fresh calibrate vignetting vs phase 20: {diff}")
    # a TIFF raw (the port's writer) through raw2rgb on the card, as the PNG
    raw = np.random.default_rng(23).integers(0, 4096, (SWEEP_SIZE, SWEEP_SIZE, 1))
    raw = raw.astype(np.uint16)
    tdir = os.path.join(calib_root, "tiff")
    os.makedirs(tdir, exist_ok=True)
    isp_path = os.path.join(tdir, "isp.json")
    with open(isp_path, "w") as f:
        json.dump(IspConfig(**ISP_KW).to_json(), f)
    write_tiff(os.path.join(tdir, "raw.tif"), raw)
    common.write_png(os.path.join(tdir, "raw.png"), raw)
    rgb = []
    for ext in ("tif", "png"):
        dest = os.path.join(tdir, f"rgb_{ext}.png")
        raw2rgb.main(["--input_image_path", os.path.join(tdir, f"raw.{ext}"),
                      "--output_image_path", dest, "--isp_config_path", isp_path,
                      "--output_bpp", "16", "--device", device_name])
        rgb.append(common.read_png(dest))
    tiff_err = int(np.abs(rgb[0].astype(np.int64) - rgb[1]).max())
    log(f"[23 tf32] calibrate vignetting in a fresh process ({time.perf_counter() - t0:.1f} s "
        f"with the TIFF check) vs phase 20's card JSON: rolloff max-abs {diff:.3g} (<= "
        f"{ROLLOFF_CPU_TOL}); raw2rgb of a {SWEEP_SIZE} px 16-bit TIFF raw on the card vs "
        f"the PNG route: max-abs {tiff_err}")
    if tiff_err:
        raise AssertionError(f"raw2rgb TIFF vs PNG: {tiff_err}")
    return {k: sum(r[k] for r in runs.values()) for k in fw.KERNELS}


def _probe_cases(rng, device):
    """(site, variant, inputs, kernel call, twin, tolerance, scale floor)
    for every K4 and K5 variant, at the smaller grid of the pair that the
    probe's main() times."""
    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS

    for name, (site, _) in KS.VARIANTS.items():
        yield (site, name, KS.make_inputs(rng, name, KS.STEPS[name][0], device),
               KS.step_cost, KS.step_cost_plain, K4_REL, 0.0)
    for name in KB.VARIANTS:
        yield (KB.SITE, name, KB.make_inputs(rng, name, KB.N1, device), KB.body_cost,
               KB.body_cost_plain, K5_REL, 1.0)


def probe_tensor_cores():
    """Per kernel of the two probe sources: ptxas's registers and spills
    and the HMMA (tensor-core) instructions of its SASS. Returns the
    failures: a kernel with a product (all but K5's no_dot kernel) and no
    HMMA."""
    from surround360_tpu_torch import cuda_build

    failed = []
    for source in sorted({os.path.basename(p) for p in PROBE_SOURCES.values()}):
        res = cuda_build.kernel_resources(source)
        for name, hmma in cuda_build.hmma_counts(source).items():
            r = res.get(name, {})
            bad = hmma == 0 and "nodot" not in name
            log(f"[14 probes] {source} {name}: {r.get('registers')} registers, spill "
                f"stores / loads {r.get('spill_stores')} / {r.get('spill_loads')} bytes, "
                f"HMMA {hmma}" + (" FAILED: no tensor-core instruction" if bad else ""))
            if bad:
                failed.append(f"{source} {name}: no HMMA")
    return failed


def probe_check():
    """Every K4 / K5 variant, kernel vs twin on the same inputs, before any
    timing, after the kernels' tensor-core check. Returns (worst max-abs
    per kernel site, the failures)."""
    import torch

    from surround360_tpu_torch.cuda_build import launch_count

    errs, failed = {}, probe_tensor_cores()
    for site, name, args, call, twin, rel, floor in _probe_cases(
            np.random.default_rng(7), torch.device("cuda", 0)):
        before = launch_count(site, name)
        got = call(name, *args)
        torch.cuda.synchronize()
        if launch_count(site, name) != before + 1:
            failed.append(f"{site} {name}: {launch_count(site, name) - before} launches counted")
        want = twin(name, *args)
        err = float((got - want).abs().max())
        scale = max(floor, float(want.abs().max()))
        bad = not bool(torch.isfinite(got).all()) or err > rel * scale
        errs[site] = max(errs.get(site, 0.0), err)
        if bad:
            failed.append(f"{site} {name} vs twin: max-abs {err} > {rel:g} x {scale:.4g}")
        log(f"[14 probes] {name} ({site}) vs twin, {args[0].shape[0]} steps: max-abs "
            f"{err:.3g} (<= {rel:g} x {scale:.4g})" + (" FAILED" if bad else ""))
    return errs, failed


def probe_bound(site, name) -> dict:
    """One step's least time on an H100: the larger of its operations at
    the rate of the precision they are held to and its bytes over 3.35
    TB/s. The products (2 FLOPs per multiply-add) run on the tensor cores
    in three passes: K4's float32 as 3xTF32 at 495 TFLOP/s, K5's ``dot3``
    as 3 bf16 passes at 989 TFLOP/s; K5's channel reduction runs at 67
    TFLOP/s; the tent and stub builds are not counted. Bytes: the
    coordinates that feed an output, the outputs, and the window rows a
    step copies (the dma variants); a window that every step shares is read
    once a grid and left out. ``simt_bound_us`` beside it is the same count
    with every FLOP at 67 TFLOP/s, float32 outside the tensor cores."""
    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS

    if site == KB.SITE:
        t = KB.VARIANTS[name]
        product = 2 * KB.PG * KB.BWB * KB.C * KB.BH if t["dot"] else 0
        other = 2 * KB.PG * KB.C * KB.BH if t["reduce"] else 0
        tc_us = 3 * product / BF16_FLOPS_PER_S * 1e6
        nbytes = (2 * KB.PG * 4 + 4 + KB.C * KB.PG * 4
                  + (KB.C * KB.BH * KB.BWB * 4 if t["dma"] and t["dot"] else 0))
    else:
        body = KS.VARIANTS[name][1]
        J = KS.out_rows(name)
        product, other = J * 2 * KS.PG * KS.BW * KS.BH, 0
        tc_us = 3 * product / TF32_FLOPS_PER_S * 1e6
        coords = 4 if body == "dots" else (J if site == KS.SITE_DYN else 1) * KS.PG * 4
        nbytes = coords + J * KS.PG * 4 + (KS.BH * KS.BW * 4 if site == KS.SITE_DMA else 0)
    flops = product + other
    flops_us = tc_us + other / F32_FLOPS_PER_S * 1e6
    simt_us, bytes_us = flops / F32_FLOPS_PER_S * 1e6, nbytes / HBM_BYTES_PER_S * 1e6
    return dict(flops=flops, tc_flops=3 * product, bytes=nbytes, flops_us=flops_us,
                bytes_us=bytes_us, bound_us=max(flops_us, bytes_us),
                bound_by="operations" if flops_us >= bytes_us else "bytes",
                simt_bound_us=max(simt_us, bytes_us))


def probe_library(site, name, args):
    """The yardstick: one batched torch.matmul (TF32 off) of the variant's
    own matrices over the steps of ``args``, built outside the timed
    region; None for K5's no_dot (no product)."""
    import torch

    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS
    from surround360_tpu_torch.benchmarks.probe_common import tent

    if site == KB.SITE:
        t = KB.VARIANTS[name]
        if not t["dot"]:
            return None
        shifts, xs, ys, win = args
        n, dev = xs.shape[0], xs.device
        x = xs[:, 0, :, None]
        ohx = (tent(x - torch.arange(KB.BWB, dtype=torch.float32, device=dev)) if t["ohx"]
               else (x * 1e-3).expand(n, KB.PG, KB.BWB)).contiguous()
        rows = torch.arange(KB.C * KB.BH, device=dev)[None]
        if t["dma"]:
            rows = rows + (torch.arange(n, device=dev) % 8 * 8)[:, None]
        shift = shifts.long() if t["roll"] else torch.zeros_like(shifts, dtype=torch.long)
        cols = torch.remainder(torch.arange(KB.BWB, device=dev)[None] - shift[:, None], KB.BW)
        wmt = win[rows[:, :, None], cols[:, None, :]].transpose(1, 2).contiguous()
        return lambda: torch.bmm(ohx, wmt)
    x, win, big = args
    n, dev = x.shape[0], x.device
    body = KS.VARIANTS[name][1]
    J = KS.out_rows(name)
    k = torch.arange(KS.BW, dtype=torch.float32, device=dev)
    if body == "dots":
        oh = (k * (x[:, 0, 0] * 1e-6)[:, None])[:, None, None, :]
        a = (oh + torch.arange(J, device=dev)[None, :, None, None]).expand(n, J, KS.PG, KS.BW)
    elif site == KS.SITE_DYN:
        a = tent(x[:, :, :, None] - k)
    else:
        a = tent(x[:, :1, :, None] - k).expand(n, J, KS.PG, KS.BW)
    if site == KS.SITE_DMA:
        rows = KS._dma_rows(x[:, 0, 0])[:, None] + torch.arange(KS.BH, device=dev)
        w = big[0][rows][:, None]  # (n, 1, BH, BW)
    elif body == "roll":
        w = torch.stack([torch.roll(win[0], o, dims=-1) for o in range(J)])[None]
    else:
        w = win[0][None, None]
    a = a.reshape(n * J, KS.PG, KS.BW).contiguous()
    bt = w.transpose(-1, -2).expand(n, J, KS.BW, KS.BH).reshape(n * J, KS.BW, KS.BH).contiguous()
    return lambda: torch.bmm(a, bt)


def phase_probes():
    """K4 and K5 as a user runs them (the two probes' main(), launches
    counted from 0), then per variant the twin's and the yardstick's us per
    step beside the bound. Returns (launches per site, the variants' rows)."""
    import torch

    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS
    from surround360_tpu_torch.benchmarks import probe_common as pc
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    res = {**KS.main([]), **KB.main([])}
    wall = time.perf_counter() - t0
    launches = {site: launch_count(site) for site in PROBE_REPLACES}
    per_variant = {name: launch_count(None, name) for name in res}
    log(f"[14 probes] kernel_step_cost.main and kernel_body_cost.main in {wall:.1f} s: "
        f"launches {launches}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a probe kernel was not launched: {launches}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    rows = []
    for name, r in res.items():
        mod, site, twin = ((KS, KS.VARIANTS[name][0], KS.step_cost_plain)
                           if name in KS.VARIANTS else (KB, KB.SITE, KB.body_cost_plain))
        make = lambda n, mod=mod, name=name, twin=twin: (
            lambda a=mod.make_inputs(rng, name, n, dev): twin(name, *a))
        plain_us = pc.per_step_us(make, 8, 32, 2)[0]
        lib = probe_library(site, name, mod.make_inputs(rng, name, LIBRARY_STEPS, dev))
        library_us = cuda_ms(lib) / LIBRARY_STEPS * 1e3 if lib else None
        del lib
        row = dict(site=site, variant=name, us=r["us_per_step"], t1_ms=r["t1_ms"],
                   t2_ms=r["t2_ms"], steps=list(r["steps"]), launches=per_variant[name],
                   plain_us=plain_us, library_us=library_us, **probe_bound(site, name))
        rows.append(row)
        lib_s = f"{library_us:.3f}" if library_us is not None else "none"
        log(f"[14 probes] {name} ({site}): {row['us']:.3f} us/step (grid {row['steps'][0]} "
            f"/ {row['steps'][1]}: {row['t1_ms']:.3f} / {row['t2_ms']:.3f} ms), bound "
            f"{row['bound_us']:.4f} us by {row['bound_by']} at the tensor-core rate "
            f"({row['tc_flops'] / 1e6:.1f} MFLOP in passes, {row['bytes'] / 1e3:.1f} KB), "
            f"{row['bound_us'] / row['us']:.1%} of bound; SIMT bound "
            f"{row['simt_bound_us']:.4f} us ({row['flops'] / 1e6:.1f} MFLOP at 67 TFLOP/s), "
            f"{row['simt_bound_us'] / row['us']:.1%}; twin {plain_us:.2f} us/step; "
            f"torch.matmul {lib_s} us/step; {row['launches']} launches")
    below = [r["variant"] for r in rows if r["bound_us"] > r["us"]]
    if below:  # faster than the card can be: the count is wrong
        raise AssertionError(f"probe steps faster than their bound: {below}")
    return launches, rows


def _probe_entry(site, launches, err, rows, nvcc_s):
    """One probe kernel site of the kernels line: per-step ms summed over
    its variants (each listed with its own numbers); library_ms over the
    variants that have a product."""
    vs = [r for r in rows if r["site"] == site]
    total = lambda k: sum(r[k] for r in vs) / 1e3
    lib = [r["library_us"] for r in vs if r["library_us"] is not None]
    return {
        "name": site,
        "route": "cuda",
        "source": PROBE_SOURCES[site],
        "replaces": PROBE_REPLACES[site],
        "launches": launches,
        "max_abs_err": err,
        "ms": total("us"),
        "plain_ms": total("plain_us"),
        "bound_ms": total("bound_us"),
        "bound_by": "operations" if total("flops_us") >= total("bytes_us") else "bytes",
        "library_ms": sum(lib) / 1e3 if lib else None,
        "nvcc_s": nvcc_s[os.path.basename(PROBE_SOURCES[site])],
        "per": "grid step",
        "variants": vs,
    }


def _counted(fn):
    """fn() with the fused window kernels' launches counted from 0: returns
    (its result, launches per kernel, seconds)."""
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops.fused_window import KERNELS

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    return out, {k: launch_count(k) for k in KERNELS}, time.perf_counter() - t0


def phase_harnesses(rig, views, ctx, inputs, device, preset=PRESET,
                    quality_preset=QUALITY_PRESET):
    """The benchmark folder's harnesses as users run them: preset_table at
    ``preset``, temporal, 3 chained frames (phase 4's context); preset_quality
    at ``quality_preset`` (2 chained frames, >= 40 dB full sphere);
    profile_stages at its defaults; flow_quality (pixflow_tpu under the JAX
    package's thresholds); trace_grid_economics on phase 4's context and
    inputs. Returns the preset_table row."""
    from surround360_tpu_torch.benchmarks import (
        flow_quality,
        preset_quality,
        preset_table,
        profile_stages,
        trace_grid_economics,
    )
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.render.profiling import STAGES

    cuda = device.type == "cuda"
    rows, launches, secs = _counted(lambda: preset_table.run(
        device, [preset], reps=3, temporal=True, rig=rig, views=views,
        contexts={preset: ctx}))
    (row,) = rows
    if "error" in row or (cuda and not launches[fw.K1]):
        raise AssertionError(f"preset_table: {row}, launches {launches}")
    log(f"[15 harnesses] preset_table {preset} temporal ({secs:.1f} s): "
        f"{json.dumps(row)}, launches {launches}")

    (qrow,), launches, secs = _counted(lambda: preset_quality.run(
        device, [quality_preset], n_chain=2, rig=rig, views=views))
    if "error" in qrow or min(qrow["psnr_full_L"], qrow["psnr_full_R"]) < PSNR_MIN:
        raise AssertionError(f"preset_quality: {qrow}")
    log(f"[15 harnesses] preset_quality {quality_preset}, 2 chained frames ({secs:.1f} s): "
        f"{json.dumps(qrow)} (full sphere >= {PSNR_MIN} dB), launches {launches}")

    rows, launches, secs = _counted(
        lambda: profile_stages.run(device, **profile_stages.settings()))
    if not set(STAGES) <= set(rows):
        raise AssertionError(f"profile_stages lacks {set(STAGES) - set(rows)}")
    log(f"[15 harnesses] profile_stages at its defaults ({secs:.1f} s): frame "
        f"{rows['frame']['host_ms']:.1f} ms host, {rows['frame']['stream_ms']} ms stream, "
        f"launches {launches}")

    frows, _, secs = _counted(lambda: flow_quality.run(device))
    for scene, base, r_low, r_tpu in frows:
        max_abs, factor = FLOW_THRESHOLDS[scene]
        if not (r_tpu < max_abs and r_tpu < base / factor):
            raise AssertionError(f"flow_quality {scene}: {r_tpu} (no flow {base})")
    log(f"[15 harnesses] flow_quality ({secs:.1f} s): pixflow_tpu RMSE " + ", ".join(
        f"{s} {t:.4f}" for s, _, _, t in frows) + " (under the JAX package's thresholds)")

    trows, launches, secs = _counted(
        lambda: trace_grid_economics.run(device, ctx=ctx, inputs=inputs))
    found = {r["site"] for r in trows if r["kernel"] == fw.K1}
    if not set(K1_SITES) <= found:
        raise AssertionError(f"trace_grid_economics lacks {set(K1_SITES) - found}")
    log(f"[15 harnesses] trace_grid_economics {ctx.config.eqr_width}x"
        f"{ctx.config.eqr_height}/eye ({secs:.1f} s): {len(trows)} (kernel, site, "
        f"offsets) lines, launches {launches}")
    return row


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


def quick():
    """``--quick``: the short check to run first after a kernel change
    (about 40 s). Phases 1-3, then K1 and K3 at the shapes the 6k product
    path gives them, on random inputs and without the pipeline around them:
    the cubemap's two remaps of a 6300x3072 panorama into 1536 px faces,
    the pole-removal warp of a 2048x2048 image under a smooth random flow
    of a few tens of px, and the pole-removal flow of a 2048x2048 pair,
    each recorded call against its twin and with phase 5's numbers; the
    same flow three times with no record open, its levels graphed: the
    capture's call launches K3 twice as often as the recorded call (the
    warm-up, then the first replay), each replay as often; last
    the ISP of two 2048x2048 frames on the card against the CPU, and its ms
    a frame for each demosaic filter. A time that depends on the data (the
    pole-removal warp's and flow's) differs from the product's."""
    import torch

    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.flow import HINT_DOWN, compute_flow, make_flow_params
    from surround360_tpu_torch.isp.pipeline import IspConfig, isp_process
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.ops.resize import gaussian_blur
    from surround360_tpu_torch.ops.window_sampler import sample_displaced
    from surround360_tpu_torch.render.panorama import RenderConfig, _cubemap
    from surround360_tpu_torch.utils import tracing

    smi = phase_device()
    phase_build()
    _, failed = phase_small()
    failed += probe_check()[1]
    if failed:
        raise AssertionError(f"phase 3 or the probes failed: {failed}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)

    # the cubemap of one eye at 6k
    ctx = SimpleNamespace(plans={}, config=RenderConfig(
        eqr_width=6300, eqr_height=3072, cubemap_width=CUBE, cubemap_height=CUBE))
    pano = rand(3, 3072, 6300)
    # the pole-removal warp: 2048 x 2048, halos of 10% of the frame
    H = W = 2048
    halo = int(0.10 * H)
    with fw.recorded() as record:
        for label in ("with its host plans", "planned"):
            t0 = time.perf_counter()
            cube = _cubemap(ctx, pano)
            torch.cuda.synchronize()
            log(f"[sites] cubemap {tuple(cube.shape)} {label}: "
                f"{time.perf_counter() - t0:.4f} s")
        flow = gaussian_blur((rand(2, H, W) - 0.5) * 4000.0, 40.0).clamp(-halo, halo)
        gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
        gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
        sample_displaced(rand(4, H, W), gx + flow[0], gy + flow[1], halo_y=halo,
                         halo_x=halo, interpolation="bicubic", border="constant", tr=16,
                         tc=128, max_window_elems=64 * 1024 * 1024,
                         site="pole_removal_warp")
    log(f"[sites] random flow of {float(flow.min()):.1f} .. {float(flow.max()):.1f} px")
    for site in K1_PRODUCT_SITES:
        _site_check("sites", (fw.K1, site, None), record, 1)

    # the pole-removal flow: one 2048 x 2048 pair
    a = rand(1, 4, H, W)
    a[:, 3] = 1.0
    b = torch.roll(a, (3, 5), dims=(-2, -1))
    a, b = gaussian_blur(a, 3.0), gaussian_blur(b, 3.0)
    reset_launch_counts()
    t0 = time.perf_counter()
    with fw.recorded() as record:
        compute_flow(a, b, make_flow_params(FLOW_ALG), site=POLE_REMOVAL_FLOW,
                     hint=torch.tensor([HINT_DOWN], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    recorded = launch_count(fw.K3)
    log(f"[sites] {FLOW_ALG} flow of a {W}x{H} pair: {time.perf_counter() - t0:.3f} "
        f"s, K3 launches {recorded}")
    # with no record open the levels run as graphs: the first call captures
    # (its warm-up, then its first replay), the next two replay
    graphed, times = [], []
    with tracing.recording():
        for _ in range(3):
            reset_launch_counts()
            t0 = time.perf_counter()
            compute_flow(a, b, make_flow_params(FLOW_ALG), site=POLE_REMOVAL_FLOW,
                         hint=torch.tensor([HINT_DOWN], dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            graphed.append(launch_count(fw.K3, POLE_REMOVAL_FLOW))
    levels = _graph_counts(tracing.session())
    log(f"[sites] the same flow with no record open: {', '.join(f'{t:.3f}' for t in times)} "
        f"s, K3 launches {graphed}, flow levels {dict(levels)}")
    if levels["flow.graph.eager"] or graphed != [2 * recorded, recorded, recorded]:
        raise AssertionError(f"graphed pole-removal flow: K3 launches {graphed}, recorded "
                             f"{recorded}, levels {dict(levels)}")
    d = lambda offs: max(abs(v) for o in offs for v in o)
    for key in sorted((k for k in record if k[0] == fw.K3), key=lambda k: -d(k[2])):
        _site_check("sites", key, record, record[key][3])

    # the ISP, card against CPU
    cfg = IspConfig(**ISP_KW)
    raw = gaussian_blur(torch.rand((2, H, W), generator=torch.Generator().manual_seed(1)), 2.0)
    on_card = raw.to(dev)
    for name in ("edge_aware", "bilinear", "frequency"):
        c = dataclasses.replace(cfg, demosaic_filter=name)
        diff = (isp_process(on_card, c).cpu() - isp_process(raw, c)).abs()
        err, share = float(diff.max()), float((diff > 1e-4).float().mean())
        ms = cuda_ms(lambda: isp_process(on_card, c)) / raw.shape[0]
        log(f"[sites] ISP {name}, sharpening on, {W}x{H}: {ms:.3f} ms a frame; "
            f"card vs CPU max-abs {err:.3g}, off by > 1e-4 on {share:.3%} of values")
        if err > ISP_STEP_MAX or share > 2 * ISP_FLIPS_MAX:
            raise AssertionError(f"ISP {name} on the card differs from the CPU")
    log(f"[sites] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(smi, flush=True)


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
    k3, k2 = phase_flow_sites(record, device)
    del record
    phase_quality(ctx, inputs, device, "pixflow_tpu_offsets", "9 quality", expect)
    del expect
    probe_err, probe_failed = probe_check()
    probe_launches, probe_rows = phase_probes()
    phase_harnesses(rig, views, ctx, inputs, device)
    phase_mesh(ctx, inputs, device)
    del ctx, inputs
    torch.cuda.empty_cache()
    root, painted = phase_unpack(rig, views)
    product_launches, record = phase_product_cli(rig, root, painted, views)
    del views, painted
    k1_new, k3_new = phase_product_sites(record)
    del record
    phase_debug_profile(rig, root)
    rec_dir = phase_capture(root)
    card_dir, cpu_dir = phase_preview(root, rec_dir)
    phase_compare(card_dir, cpu_dir)
    # calibration (phases 19-21) runs no hand kernel: the counts stay 0
    from surround360_tpu_torch.cuda_build import launch_count, reset_launch_counts
    from surround360_tpu_torch.ops import fused_window as fw

    reset_launch_counts()
    calib_root = os.path.join(WORK, "calib")
    phase_calib_unit(calib_root, rig)
    phase_calib_noise(rig)
    phase_calib_match(calib_root, rig)
    phase_vignetting(calib_root)
    phase_color(calib_root)
    calib_launches = {k: launch_count(k) for k in fw.KERNELS}
    calib_launches["K4, K5"] = launch_count() - sum(calib_launches.values())
    log(f"[21 color] kernel launches in phases 19-21: {calib_launches}")
    if any(calib_launches.values()):
        raise AssertionError(f"calibration launched a sampler kernel: {calib_launches}")
    bench_launches = phase_bench_entries(calib_root)
    shutil.rmtree(WORK, ignore_errors=True)
    if small_failed or probe_failed:
        raise AssertionError(f"phase 3 or 14 failed: {small_failed + probe_failed}")
    # ms, cold_ms, plain_ms, library_ms, bound_ms: summed over the recorded
    # calls (K1: the largest per call site, phases 5 and 12; K3: the largest
    # per flow site and offset set, phases 8 and 12; K2: its forced call in
    # phase 8).
    # launches: the product paths' runs with no record open, as users run
    # them (phase 4's render_frame, phase 7's CLI and phase 11's CLI with
    # pole removal and a cubemap, their flow levels graphed: a capture's
    # warm-up and each replay count; phase 23's bench in both modes and the
    # root entry's counterpart), counted from 0 just before each; K2 has no
    # product caller, so 0
    launches = {k: render_launches[k] + cli_launches[k] + product_launches[k]
                + bench_launches[k] for k in render_launches}
    entries = [
        _kernel_entry(name, launches[name], small[name], sites, nvcc_s)
        for name, sites in (("fused_window_sample", k1 + k1_new),
                            ("fused_window_folded", [k2]),
                            ("fused_window_offsets", k3 + k3_new))
    ] + [
        # ms, plain_ms, bound_ms, library_ms: per grid step, summed over the
        # site's variants (phase 14); launches: the probes' main() run
        _probe_entry(site, probe_launches[site], probe_err[site], probe_rows, nvcc_s)
        for site in PROBE_REPLACES
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--quick"]):
        sys.exit("usage: python3 chip_smoke.py [--quick]")
    quick() if sys.argv[1:] else main()
