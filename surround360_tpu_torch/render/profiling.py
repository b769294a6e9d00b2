"""Per-stage time breakdown of the frame pipeline.

Port of ``surround360_tpu/render/profiling.py``. The reference logs a
per-frame stage table (projection / side flow / novel view / pole flow /
sharpen, TestRenderStereoPanorama.cpp:963-971); here each stage is run by
the renderer's own stage function on the given frame's inputs and timed in
isolation: with CUDA events on a GPU, with the host clock on the CPU. The
table gives each stage's milliseconds, its share of the whole frame and
the launches of the fused window kernels that ``ops/fused_window.py``
counted during one run of it. Wired into ``cli/render_video`` via
``--profile_stages``.

The reference's XLA cost analysis, trace and compile seconds, dispatch
floor and roofline columns have no counterpart in an eager PyTorch
renderer and are not reproduced.
"""

from __future__ import annotations

import logging
import time

import torch

from ..flow import HINT_DOWN, compute_flow, make_flow_params
from ..ops import fused_window as fw
from ..ops.compositing import feather_alpha, offset_horizontal_wrap, stack_horizontal
from ..ops.resize import resize_area
from ..views.novel_view import render_chunk_pair
from .panorama import (
    _finalize_outputs,
    _merge_poles,
    _pad_to_height,
    _pole_to_side_flow,
    _poles_to_side_flow,
    _prepare_fisheye_strip,
    _project_side_cameras,
    _render_ring,
    _side_pair_flows,
    render_frame,
)

__all__ = ["STAGES", "stage_breakdown", "format_breakdown"]

log = logging.getLogger(__name__)

# stage -> the stages whose outputs it consumes
_DEPS = {
    "projection": set(),
    "side_flow": {"projection"},
    "novel_view": {"side_flow"},
    "ring_total": set(),
    "fisheye_strip": set(),
    "pole_flow_solve": {"novel_view", "fisheye_strip"},
    "pole_flow_composite_one": {"novel_view", "fisheye_strip"},
    "pole_merged": {"novel_view", "fisheye_strip"},
    "output": set(),
    "full_frame": set(),
}
STAGES = tuple(_DEPS)


def _time(fn, device, reps: int):
    """One warm run of ``fn`` (its kernel launches counted), then ``reps``
    timed runs. Returns (seconds per run, launches per kernel, output)."""
    before = {k: fw.launch_count(k) for k in fw.KERNELS}
    out = fn()
    launches = {k: fw.launch_count(k) - before[k] for k in fw.KERNELS}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps, launches, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, launches, out


def stage_breakdown(ctx, side, top=None, bottom=None, reps: int = 5, stages=None):
    """Time each pipeline stage in isolation on the given frame inputs
    (tensors on the render device).

    Returns (times, launches): {stage: seconds per run} and {stage:
    {kernel: launches in one run}}. Beside the measured stages, times
    holds ``pole_warp_blend`` (the one-pole composite less its flow solve)
    when both were measured. Stages log as they complete, so a failing
    stage leaves the earlier measurements on record.

    stages: optional set of names from :data:`STAGES` (None = all). A stage
    that a selected stage's input depends on is run and timed as well.
    ``ring_total`` and ``full_frame`` rerun stages already measured; the
    pole stages need ``top``."""
    cfg = ctx.config
    device = side.device
    times: dict = {}
    launches: dict = {}

    if stages is None:
        need = set(STAGES)
    else:
        unknown = set(stages) - set(STAGES)
        if unknown:
            raise ValueError(f"unknown stages: {sorted(unknown)}")
        need = set(stages)
        while True:
            grown = need | {d for s in need for d in _DEPS[s]}
            if grown == need:
                break
            need = grown
    want = need.__contains__

    def record(name, fn):
        times[name], launches[name], out = _time(fn, device, reps)
        log.info("stage %s: %.1f ms, launches %s", name, times[name] * 1e3,
                 {k: n for k, n in launches[name].items() if n})
        return out

    pano2 = None
    if want("projection"):
        projections = record("projection", lambda: _project_side_cameras(ctx, side))
        ov = ctx.overlap_w
        overlap_l = projections[..., ctx.strip_w - ov :]
        overlap_r = torch.roll(projections, -1, dims=0)[..., :ov]
    if want("side_flow"):
        flow_ltr, flow_rtl = record(
            "side_flow",
            lambda: _side_pair_flows(ctx, overlap_l, overlap_r, {}, False)[:2],
        )
    if want("novel_view"):
        # chunk render + panorama assembly (the stacking is negligible)
        def chunks_and_pano():
            chunks_l, chunks_r = render_chunk_pair(
                overlap_l, overlap_r, flow_ltr, flow_rtl,
                ctx.warp_cols_l, ctx.t_cols, ctx.warp_cols_r,
            )
            pano_l = stack_horizontal(list(chunks_l.unbind(0)))
            pano_r = stack_horizontal(list(chunks_r.unbind(0)))
            pano_l = offset_horizontal_wrap(pano_l, ctx.zero_parallax_shift_px)
            pano_r = offset_horizontal_wrap(pano_r, -ctx.zero_parallax_shift_px)
            return torch.stack([
                _pad_to_height(pano_l, cfg.eqr_height),
                _pad_to_height(pano_r, cfg.eqr_height),
            ])

        pano2 = record("novel_view", chunks_and_pano)
    if want("ring_total"):
        record(
            "ring_total",
            lambda: _render_ring(ctx, _project_side_cameras(ctx, side), {}, False)[:2],
        )

    if cfg.enable_top and top is not None and want("fisheye_strip"):
        top_strip = record(
            "fisheye_strip",
            lambda: _prepare_fisheye_strip(
                ctx, "top", ctx.top_h, top, cfg.std_alpha_feather_size
            ),
        )
        if want("pole_flow_solve"):
            # just the pole-to-side flow solve, on the inputs that
            # _pole_flow_core prepares, so that the composite splits into
            # flow and warp + blend
            rows_f, eqr_w = top_strip.shape[-2:]
            ext_w = int(eqr_w * 1.2)
            flow_params = make_flow_params(cfg.polar_flow_alg)._replace(
                window_halo_y_frac=0.30, window_halo_x_frac=0.10
            )
            pscale = cfg.polar_flow_scale

            def pole_flow_only():
                ext = lambda a: torch.cat([a, a[..., : ext_w - eqr_w]], dim=-1)
                ext_side = ext(feather_alpha(
                    pano2[..., :rows_f, :], cfg.std_alpha_feather_size
                ))
                ext_fish = ext(top_strip[None].expand((2,) + top_strip.shape))
                hints = torch.full((2,), HINT_DOWN, dtype=torch.int32, device=device)
                if pscale != 1.0:
                    fh, fw_ = int(rows_f * pscale), int(ext_w * pscale)
                    ext_side = resize_area(ext_side, (fh, fw_))
                    ext_fish = resize_area(ext_fish, (fh, fw_))
                return compute_flow(ext_side, ext_fish, flow_params, hint=hints,
                                    site="pole_flow")

            record("pole_flow_solve", pole_flow_only)
        if want("pole_flow_composite_one"):
            record(
                "pole_flow_composite_one",
                lambda: _pole_to_side_flow(ctx, pano2, top_strip, "top", {}, False)[0],
            )
            if "pole_flow_solve" in times:
                times["pole_warp_blend"] = max(
                    0.0, times["pole_flow_composite_one"] - times["pole_flow_solve"]
                )
        if want("pole_merged") and _merge_poles(ctx):
            # both poles in one batch of 4: compare with twice the one-pole
            # composite
            record(
                "pole_merged",
                lambda: _poles_to_side_flow(ctx, pano2, top_strip, top_strip, {}, False)[0],
            )

    if want("output"):
        # sharpen + cubemap + final resize + stereo stack, on the ring's
        # panorama (zeros when the ring was not selected)
        pano2_in = pano2 if pano2 is not None else torch.zeros(
            (2, 4, cfg.eqr_height, cfg.eqr_width), dtype=torch.float32, device=device
        )
        record("output", lambda: _finalize_outputs(ctx, pano2_in)["equirect"])

    if want("full_frame"):
        record(
            "full_frame",
            lambda: render_frame(ctx, side, top, bottom)[0]["equirect"],
        )
    return times, launches


def format_breakdown(times: dict, launches: dict | None = None) -> str:
    """The stage table: milliseconds per run, the share of ``full_frame``
    (when it was measured) and the kernels' launches in one run."""
    launches = launches or {}
    frame = times.get("full_frame")
    lines = ["stage breakdown (each stage alone, ms per run; kernel launches "
             "in one run):"]
    for name, secs in times.items():
        line = f"  {name:26s} {secs * 1e3:10.2f} ms"
        line += f"  {secs / frame * 100:5.1f}% of frame" if frame else ""
        counts = {k: n for k, n in launches.get(name, {}).items() if n}
        if counts:
            line += "  " + ", ".join(f"{k} x{n}" for k, n in counts.items())
        lines.append(line)
    return "\n".join(lines)
