"""Per-frame stereo render driver with temporal regularization + resume.

Port of ``surround360_tpu/cli/render_video.py`` (scripts/
batch_process_video.py + the TestRenderStereoPanorama invocation loop),
built on the port's eager :func:`~..render.panorama.render_frame`:

    python -m surround360_tpu_torch.cli.render_video --rig_json_file rig.json \\
        --imgs_dir imgs --output_dir out --quality 6k --enable_top \\
        --enable_bottom --side_flow_alg pixflow_tpu_offsets \\
        --polar_flow_alg pixflow_tpu_offsets --save_state_dir state

renders frames [start, end] from ``imgs_dir/<camera id>/<frame>.png`` to
``output_dir/eqr_frames/eqr_<frame>.png`` (and ``cube_<frame>.png`` with
``--cubemap_width`` / ``--cubemap_height``), carrying the temporal flow
state from frame to frame on the device. ``--enable_pole_removal`` merges
the two bottom cameras first (``render.pole``; red-painted masks named
``<camera id>.png`` in ``--bottom_pole_masks_dir``), with its own flow
prior carried the same way. With ``--save_state_dir`` each frame's state
is pickled (numpy arrays; the pole-removal prior under ``pole:`` keys) and
the state two frames back is deleted once this frame's save succeeded;
``--resume_state`` continues from such a pickle, written by either
package.

The loop is one frame deep, as in the reference: frame t is dispatched
before frame t-1's outputs are fetched, PNG encoding and state pickling
run on a writer thread that also prefetches frame t+1's inputs, writer
errors surface at the next frame, and the in-flight frame is flushed on
abort. It runs on the GPU (``--device cuda``, the default) and raises
when there is none; ``--device cpu`` renders on the CPU. A
:class:`~.common.StageTimer` collects the loop's host-side stages (see
:func:`render_video`) and the breakdown is logged at the end.

``--save_debug_images`` writes each frame's intermediates under
``output_dir/debug/<frame>/`` (the side projections as ``crop_<camera
id>.png``, ``spherical_l|r``, the poles' ``*_strip`` and per-eye
``*_warped_left|right``) and runs the loop synchronously, the poles one at
a time. ``--profile_stages`` renders the frames with tracing on and
logs each frame's stage table (``render.profiling``, read from its spans)
once its outputs are fetched. Every frame renders eagerly through ``render_frame``, where the reference jits
and stages its renderer.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..flow import make_flow_params
from ..geometry.rig import load_rig
from ..render.panorama import (
    RenderConfig,
    build_render_context,
    render_frame,
    state_from_blob,
    state_to_blob,
)
from ..render.pole import combine_bottom_images_with_pole_removal
from ..render.profiling import format_breakdown, stage_breakdown
from ..utils import tracing
from .common import (
    StageTimer,
    log,
    read_image_rgba,
    resolve_device,
    setup_logging,
    write_image,
)

QUALITY_PRESETS = {
    # name -> (eqr_width, eqr_height, final_width, final_height); the final
    # height counts BOTH stacked eyes (batch_process_video.py:176-199)
    "3k": (3080, 1540, 3080, 3080),
    "4k": (4200, 1024, 4096, 2048),
    "6k": (6300, 3072, 6144, 6144),
    "8k": (8400, 4096, 8192, 8192),
    "preview": (1008, 504, 1008, 1008),
}

# every reference quality preset sharpens at 0.25
# (batch_process_video.py:177,183,189,195)
PRESET_SHARPENING = 0.25

# side pair flows on overlaps downscaled by this factor at large presets
# (RenderConfig.side_flow_scale)
PRESET_SIDE_FLOW_SCALE = {"6k": 0.5, "8k": 0.5}


# debug layers written per frame, where the frame has them
_DEBUG_KEYS = ("spherical_l", "spherical_r", "top_strip", "top_warped",
               "bottom_strip", "bottom_warped")


def _load_pole_mask(masks_dir, cam_id, hw) -> np.ndarray:
    """Red pole mask PNG -> (H, W) bool (True where the pole is); all
    False without a masks directory or a file for this camera."""
    if masks_dir is None:
        return np.zeros(hw, dtype=bool)
    path = os.path.join(masks_dir, f"{cam_id}.png")
    if not os.path.exists(path):
        return np.zeros(hw, dtype=bool)
    rgba = read_image_rgba(path)
    return (rgba[0] > 0.99) & (rgba[1] < 0.01) & (rgba[2] < 0.01)


def _write_debug_images(dbg_dir: str, debug: dict, side_ids) -> None:
    """The frame's intermediates as PNGs (the reference's
    --save_debug_images tree)."""
    os.makedirs(dbg_dir, exist_ok=True)
    for cam_id, proj in zip(side_ids, debug["projections"].cpu().numpy()):
        write_image(os.path.join(dbg_dir, f"crop_{cam_id}.png"), proj)
    for key in _DEBUG_KEYS:
        if key not in debug:
            continue
        arr = debug[key].cpu().numpy()
        if arr.ndim == 4:  # (2, 4, H, W) per-eye layers
            for eye, name in enumerate(("left", "right")):
                write_image(os.path.join(dbg_dir, f"{key}_{name}.png"), arr[eye])
        else:
            write_image(os.path.join(dbg_dir, f"{key}.png"), arr)


def render_video(
    rig_json: str,
    imgs_dir: str,
    output_dir: str,
    start_frame: int,
    end_frame: int,
    config: RenderConfig,
    pole_masks_dir: str | None = None,
    save_state_dir: str | None = None,
    resume_state: str | None = None,
    save_debug_images: bool = False,
    profile_stages: bool = False,
    timer: StageTimer | None = None,
    device: str = "cuda",
):
    """Render frames [start_frame, end_frame] on ``device`` ("cuda", the
    default, raises when CUDA is not available; "cpu" renders on the CPU);
    returns the last frame's temporal state (tensors on that device).

    ``timer`` (a fresh one when None) receives one entry per frame for each
    stage: ``decode`` (the cameras' PNGs, on the writer thread, overlapping
    the previous frame), ``wait_inputs`` (the loop blocked on that decode),
    ``pole_removal`` (with pole removal: the two bottom cameras combined),
    ``render`` (``render_frame``), ``fetch`` (the outputs to the host),
    ``encode`` (each output PNG, writer thread) and ``save_state`` (writer
    thread); then ``drain`` (the loop waiting for the writer) and ``loop``
    (the whole frame loop)."""
    timer = StageTimer() if timer is None else timer
    device = resolve_device(device)
    rig = load_rig(rig_json)
    ctx = build_render_context(rig, config)
    os.makedirs(os.path.join(output_dir, "eqr_frames"), exist_ok=True)

    # the pickle holds the ring state and the pole-removal prior ("pole:"
    # keys): the reference persists the pole flow per frame and re-reads it
    # (PoleRemoval.cpp:120-128), so a resumed render restores both
    state = None
    pole_state: dict = {}
    if resume_state:
        with open(resume_state, "rb") as f:
            state, pole_state = state_from_blob(pickle.load(f), device)
        log.info("resumed temporal state from %s (%d ring keys, %d pole keys)",
                 resume_state, len(state or {}), len(pole_state))

    writer = ThreadPoolExecutor(max_workers=2)
    write_futs: list = []
    pending = None  # (frame_name, outputs, state, pole_state, t_dispatch, frame span id)

    def _flush(pend):
        """Fetch a dispatched frame's outputs (waits for the device) and
        hand PNG encoding and state pickling to the writer thread."""
        frame_name, outputs, state_, pole_state_, t_disp, frame_span = pend
        with timer.stage("fetch"):
            images = {"eqr": outputs["equirect"].cpu().numpy()}
            if "cubemap" in outputs:
                images["cube"] = outputs["cubemap"].cpu().numpy()
        if frame_span is not None:
            # the reference's per-frame stage log (TestRenderStereoPanorama.cpp:963-971),
            # read once the fetch has waited for the frame's work
            rows = stage_breakdown(tracing.session(), frame=frame_span)
            log.info("%s", format_breakdown(rows, f" of frame {frame_name}"))

        def _encode(path, img):
            with timer.stage("encode"):
                write_image(path, img)

        for kind, img in images.items():
            path = os.path.join(output_dir, "eqr_frames", f"{kind}_{frame_name}.png")
            write_futs.append(writer.submit(_encode, path, img))
        if save_state_dir:
            os.makedirs(save_state_dir, exist_ok=True)
            blob = state_to_blob(state_, pole_state_)

            def _save_state(blob=blob, frame_name=frame_name):
                path = os.path.join(save_state_dir, f"state_{frame_name}.pkl")
                with timer.stage("save_state"), open(path, "wb") as f:
                    pickle.dump(blob, f)

            fut = writer.submit(_save_state)
            write_futs.append(fut)

            # delete the state two frames back only once THIS frame's save
            # succeeded, so two recent states are on disk at every instant
            # (batch_process_video.py:212-228)
            def _gc_stale(f, stale_frame=int(frame_name) - 2):
                if f.exception() is not None:
                    return
                stale = os.path.join(save_state_dir, f"state_{stale_frame:06d}.pkl")
                try:
                    os.remove(stale)
                except FileNotFoundError:
                    pass

            fut.add_done_callback(_gc_stale)
        log.info("frame %s rendered in %.2fs", frame_name,
                 (tracing.now_ns() - t_disp) * 1e-9)

    poles = [k for k in ("top", "bottom") if getattr(config, f"enable_{k}")]
    pole_removal = config.enable_bottom and config.enable_pole_removal
    if pole_removal:
        poles.append("bottom2")
    cam_index = {"top": "top_camera_index", "bottom": "bottom_camera_index",
                 "bottom2": "bottom_camera2_index"}
    pole_ids = [rig.ids[getattr(rig, cam_index[k])] for k in poles]
    decoder = ThreadPoolExecutor(max_workers=8)
    masks: dict = {}  # camera id -> (H, W) bool tensor, read at the first frame

    def _pole_mask(cam_id: str, hw):
        if cam_id not in masks:
            masks[cam_id] = torch.from_numpy(
                _load_pole_mask(pole_masks_dir, cam_id, tuple(hw))).to(device)
        return masks[cam_id]

    def _remove_pole(bottom, bottom2):
        """(combined bottom image, the next frame's pole-removal prior)."""
        ids = dict(zip(poles, pole_ids))
        combined, pole_flow = combine_bottom_images_with_pole_removal(
            bottom, bottom2,
            _pole_mask(ids["bottom"], bottom.shape[-2:]),
            _pole_mask(ids["bottom2"], bottom2.shape[-2:]),
            ctx.bottom_usable_radius, ctx.bottom2_usable_radius,
            ctx.pole_flip180, make_flow_params(config.poleremoval_flow_alg),
            config.std_alpha_feather_size,
            prev_flow=pole_state.get("pole_flow"),
            prev_bottom=pole_state.get("prev_bottom"),
            prev_bottom2=pole_state.get("prev_bottom2"),
            use_temporal="pole_flow" in pole_state,
        )
        # as the reference keeps it: the combined primary, the raw secondary
        return combined, {"pole_flow": pole_flow, "prev_bottom": combined,
                          "prev_bottom2": bottom2}

    def _read_frame_inputs(frame: int) -> dict:
        """Decode one frame's camera PNGs on the host (prefetchable), the
        cameras in parallel (zlib and numpy release the GIL)."""
        name = f"{frame:06d}.png"
        read = lambda cam_id: read_image_rgba(os.path.join(imgs_dir, cam_id, name))
        with timer.stage("decode"):
            imgs = list(decoder.map(read, list(rig.side_ids) + pole_ids))
        n = len(rig.side_ids)
        return {"side": np.stack(imgs[:n]), **dict(zip(poles, imgs[n:]))}

    def _surface_writer_errors():
        """Raise now if a finished writer task failed."""
        remaining = []
        for f in write_futs:
            if f.done():
                f.result()
            else:
                remaining.append(f)
        write_futs[:] = remaining

    to_dev = lambda a: None if a is None else torch.from_numpy(a).to(device)
    traced = tracing.recording() if profile_stages else contextlib.nullcontext()
    with traced:
        try:
            t_start = tracing.now_ns()
            read_fut = writer.submit(_read_frame_inputs, start_frame)
            for frame in range(start_frame, end_frame + 1):
                t0 = tracing.now_ns()
                with timer.stage("wait_inputs"):
                    ins = read_fut.result()
                if frame < end_frame:
                    read_fut = writer.submit(_read_frame_inputs, frame + 1)
                side, top, bottom = (to_dev(ins.get(k)) for k in ("side", "top", "bottom"))
                if pole_removal:
                    with timer.stage("pole_removal"):
                        bottom, pole_state = _remove_pole(bottom, to_dev(ins["bottom2"]))
                with timer.stage("render"):
                    outputs, state = render_frame(
                        ctx, side, top, bottom, state=state,
                        use_temporal=state is not None, save_debug=save_debug_images,
                    )
                frame_span = None
                if profile_stages:
                    frame_span = next(s.id for s in reversed(tracing.session())
                                      if s.name == "frame")
                frame_name = f"{frame:06d}"
                if save_debug_images:
                    _write_debug_images(os.path.join(output_dir, "debug", frame_name),
                                        outputs["debug"], rig.side_ids)
                # one frame deep: fetch the previous frame only once this one is
                # in the device's queue; the debug path stays synchronous
                prev_pending = pending
                pending = (frame_name, outputs, state, pole_state, t0, frame_span)
                if save_debug_images:
                    _flush(pending)
                    pending = None
                elif prev_pending is not None:
                    _flush(prev_pending)
                _surface_writer_errors()
            if pending is not None:
                _flush(pending)
                pending = None
            with timer.stage("drain"):
                for fut in write_futs:
                    fut.result()
            write_futs.clear()
            n = end_frame - start_frame + 1
            elapsed = (tracing.now_ns() - t_start) * 1e-9
            timer.stages.append(("loop", elapsed))
            log.info("rendered %d frames in %.3fs (%.3f s/frame)", n, elapsed, elapsed / n)
            log.info("stage seconds (count): %s", ", ".join(
                f"{name} {secs:.3f} ({count})"
                for name, (count, secs) in timer.totals().items()))
        finally:
            # on abort, persist the already-dispatched frame and stop the writer
            if pending is not None:
                try:
                    _flush(pending)
                except Exception:
                    log.exception("failed to flush the in-flight frame on abort")
            for fut in write_futs:
                try:
                    fut.result()
                except Exception:
                    log.exception("writer task failed during shutdown")
            writer.shutdown(wait=True)
            decoder.shutdown(wait=True)
    return state


def main(argv=None, timer: StageTimer | None = None):
    """The command line; ``timer`` as in :func:`render_video`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig_json_file", required=True)
    p.add_argument("--imgs_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=0)
    p.add_argument("--quality", default="preview", choices=QUALITY_PRESETS)
    p.add_argument("--interpupilary_dist", type=float, default=6.4)
    p.add_argument("--zero_parallax_dist", type=float, default=10000.0)
    p.add_argument(
        "--sharpening", type=float, default=PRESET_SHARPENING,
        help="unsharp amount; the reference sets 0.25 for every quality "
        "preset (batch_process_video.py:176-199)",
    )
    p.add_argument("--enable_top", action="store_true")
    p.add_argument("--enable_bottom", action="store_true")
    p.add_argument("--enable_pole_removal", action="store_true")
    p.add_argument("--bottom_pole_masks_dir", default=None)
    p.add_argument("--side_flow_alg", default="pixflow_tpu")
    p.add_argument("--polar_flow_alg", default="pixflow_tpu")
    p.add_argument("--poleremoval_flow_alg", default="pixflow_tpu")
    p.add_argument("--cubemap_width", type=int, default=0)
    p.add_argument("--cubemap_height", type=int, default=0)
    p.add_argument("--cubemap_format", default="video")
    p.add_argument("--save_state_dir", default=None)
    p.add_argument("--resume_state", default=None)
    p.add_argument("--save_debug_images", action="store_true")
    p.add_argument("--profile_stages", action="store_true",
                   help="render with tracing on and log each frame's stage table")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)

    eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[args.quality]
    cfg = RenderConfig(
        eqr_width=eqr_w,
        eqr_height=eqr_h,
        final_eqr_width=fin_w,
        final_eqr_height=fin_h,
        interpupilary_dist=args.interpupilary_dist,
        zero_parallax_dist=args.zero_parallax_dist,
        sharpening=args.sharpening,
        side_flow_scale=PRESET_SIDE_FLOW_SCALE.get(args.quality, 1.0),
        enable_top=args.enable_top,
        enable_bottom=args.enable_bottom,
        enable_pole_removal=args.enable_pole_removal,
        side_flow_alg=args.side_flow_alg,
        polar_flow_alg=args.polar_flow_alg,
        poleremoval_flow_alg=args.poleremoval_flow_alg,
        cubemap_width=args.cubemap_width,
        cubemap_height=args.cubemap_height,
        cubemap_format=args.cubemap_format,
    )
    return render_video(
        args.rig_json_file,
        args.imgs_dir,
        args.output_dir,
        args.start_frame,
        args.end_frame,
        cfg,
        pole_masks_dir=args.bottom_pole_masks_dir,
        save_state_dir=args.save_state_dir,
        resume_state=args.resume_state,
        save_debug_images=args.save_debug_images,
        profile_stages=args.profile_stages,
        timer=timer,
        device=args.device,
    )


if __name__ == "__main__":
    main()
