"""Per-frame stereo render driver with temporal regularization + resume.

Port of ``surround360_tpu/cli/render_video.py`` (scripts/
batch_process_video.py + the TestRenderStereoPanorama invocation loop),
built on the port's eager :func:`~..render.panorama.render_frame`:

    python -m surround360_tpu_torch.cli.render_video --rig_json_file rig.json \\
        --imgs_dir imgs --output_dir out --quality 6k --enable_top \\
        --enable_bottom --side_flow_alg pixflow_tpu_offsets \\
        --polar_flow_alg pixflow_tpu_offsets --save_state_dir state

renders frames [start, end] from ``imgs_dir/<camera id>/<frame>.png`` to
``output_dir/eqr_frames/eqr_<frame>.png``, carrying the temporal flow state
from frame to frame on the device. With ``--save_state_dir`` each frame's
state is pickled (numpy arrays; the reference's ``pole:`` keys are kept
as they are) and the state two frames back is deleted once this frame's
save succeeded; ``--resume_state`` continues from such a pickle, written
by either package.

The loop is one frame deep, as in the reference: frame t is dispatched
before frame t-1's outputs are fetched, PNG encoding and state pickling
run on a writer thread that also prefetches frame t+1's inputs, writer
errors surface at the next frame, and the in-flight frame is flushed on
abort. It runs on the GPU (``--device cuda``, the default) and raises
when there is none; ``--device cpu`` renders on the CPU. A
:class:`~.common.StageTimer` collects the loop's host-side stages (see
:func:`render_video`) and the breakdown is logged at the end.

Not ported yet (they raise ``NotImplementedError`` before any frame is
read): pole removal and cubemap output (ROADMAP A10), ``--save_debug_images``
and ``--profile_stages`` (ROADMAP A11b); the reference's jitted and staged
renderer has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..geometry.rig import load_rig
from ..render.panorama import (
    RenderConfig,
    build_render_context,
    render_frame,
    state_from_numpy,
    state_to_numpy,
)
from .common import StageTimer, log, read_image_rgba, setup_logging, write_image

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


def _check_ported(config: RenderConfig, save_debug_images: bool,
                  profile_stages: bool) -> None:
    """Raise for the reference's options the port does not have yet."""
    if config.enable_pole_removal:
        raise NotImplementedError("--enable_pole_removal: pole removal is ROADMAP A10")
    if config.cubemap_width or config.cubemap_height or config.cubemap_format != "video":
        raise NotImplementedError("--cubemap_*: cubemap output is ROADMAP A10")
    if save_debug_images:
        raise NotImplementedError("--save_debug_images is ROADMAP A11b")
    if profile_stages:
        raise NotImplementedError("--profile_stages is ROADMAP A11b")


def _resolve_device(name: str) -> torch.device:
    """The render device; CUDA must be there when asked for (no silent
    fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available (pass --device cpu to "
            "render on the CPU)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {name}")
    return device


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
    ``render`` (``render_frame``), ``fetch`` (the output to the host),
    ``encode`` (the output PNG, writer thread) and ``save_state`` (writer
    thread); then ``drain`` (the loop waiting for the writer) and ``loop``
    (the whole frame loop)."""
    del pole_masks_dir  # read by pole removal only (ROADMAP A10)
    _check_ported(config, save_debug_images, profile_stages)
    timer = StageTimer() if timer is None else timer
    device = _resolve_device(device)
    rig = load_rig(rig_json)
    ctx = build_render_context(rig, config)
    os.makedirs(os.path.join(output_dir, "eqr_frames"), exist_ok=True)

    # the pickle holds the ring state and the reference's pole-removal
    # prior ("pole:" keys); the port carries the latter through unchanged
    state = None
    pole_state: dict = {}
    if resume_state:
        with open(resume_state, "rb") as f:
            blob = pickle.load(f)
        pole_state = {k: v for k, v in blob.items() if k.startswith("pole:")}
        ring = {k: v for k, v in blob.items() if not k.startswith("pole:")}
        state = state_from_numpy(ring, device) if ring else None
        log.info("resumed temporal state from %s (%d ring keys, %d pole keys)",
                 resume_state, len(ring), len(pole_state))

    writer = ThreadPoolExecutor(max_workers=2)
    write_futs: list = []
    pending = None  # (frame_name, outputs, state, t_dispatch)

    def _flush(pend):
        """Fetch a dispatched frame's outputs (waits for the device) and
        hand PNG encoding and state pickling to the writer thread."""
        frame_name, outputs, state_, t_disp = pend
        with timer.stage("fetch"):
            eqr = outputs["equirect"].cpu().numpy()
        eqr_path = os.path.join(output_dir, "eqr_frames", f"eqr_{frame_name}.png")

        def _encode(eqr=eqr, eqr_path=eqr_path):
            with timer.stage("encode"):
                write_image(eqr_path, eqr)

        write_futs.append(writer.submit(_encode))
        if save_state_dir:
            os.makedirs(save_state_dir, exist_ok=True)
            blob = state_to_numpy(state_ or {})
            blob.update(pole_state)

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
        log.info("frame %s rendered in %.2fs", frame_name, time.time() - t_disp)

    poles = [k for k in ("top", "bottom") if getattr(config, f"enable_{k}")]
    pole_ids = [rig.ids[getattr(rig, f"{k}_camera_index")] for k in poles]
    decoder = ThreadPoolExecutor(max_workers=8)

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
    try:
        t_start = time.time()
        read_fut = writer.submit(_read_frame_inputs, start_frame)
        for frame in range(start_frame, end_frame + 1):
            t0 = time.time()
            with timer.stage("wait_inputs"):
                ins = read_fut.result()
            if frame < end_frame:
                read_fut = writer.submit(_read_frame_inputs, frame + 1)
            with timer.stage("render"):
                outputs, state = render_frame(
                    ctx, to_dev(ins["side"]), to_dev(ins.get("top")),
                    to_dev(ins.get("bottom")), state=state,
                    use_temporal=state is not None,
                )
            # one frame deep: fetch the previous frame only now
            prev_pending, pending = pending, (f"{frame:06d}", outputs, state, t0)
            if prev_pending is not None:
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
        elapsed = time.time() - t_start
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
                   help="log a per-stage device-time table before rendering")
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
