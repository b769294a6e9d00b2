"""A compile check and a multi-device dry run of the renderer.

Port of the reference's root ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, example_args)``: ``fn(side, top, bottom)``
  renders one 280x140 stereo frame (the ring rig at 1/16 scale,
  ``pixflow_tpu`` on the ring and the poles, both poles) and returns
  ``render_frame``'s ``equirect`` on the inputs' device.
- :func:`dryrun_multichip` runs ``parallel/mesh.py``'s sharded step over
  a (data, ring) mesh of n devices and a camera-width (1, 14) ring, two
  temporal steps chained through the returned states, and holds both to
  the sequential ``render_frame`` chain within 1e-4.

Both run on ``device`` (``cuda`` by default; it raises without CUDA). The
mesh's devices are ``device`` repeated: one card (or the CPU) stands for
n members, as the reference's virtual CPU devices do. The reference's
``XLA_FLAGS`` handling has no counterpart.
"""

from __future__ import annotations

import torch

from .cli.common import resolve_device

__all__ = ["entry", "dryrun_multichip"]

DRYRUN_TOL = 1e-4


def _make_inputs(scale: float, eqr_w: int, eqr_h: int, device):
    from .benchmarks.preset_table import frame_inputs
    from .capture import render_camera_views
    from .geometry.rig import make_ring_rig
    from .render.panorama import RenderConfig, build_render_context

    rig = make_ring_rig().rescaled(scale)
    cfg = RenderConfig(
        eqr_width=eqr_w,
        eqr_height=eqr_h,
        side_flow_alg="pixflow_tpu",
        polar_flow_alg="pixflow_tpu",
        enable_top=True,
        enable_bottom=True,
    )
    ctx = build_render_context(rig, cfg)
    side, top, bottom = frame_inputs(rig, render_camera_views(rig), device)
    return ctx, side, top, bottom


def entry(device="cuda"):
    """(fn, example_args): the full-frame stereo render step on
    ``device`` and its inputs."""
    from .render.panorama import render_frame

    ctx, side, top, bottom = _make_inputs(0.0625, 280, 140, resolve_device(str(device)))

    def forward(side_images, top_image, bottom_image):
        outputs, _ = render_frame(ctx, side_images, top_image, bottom_image)
        return outputs["equirect"]

    return forward, (side, top, bottom)


def _chain(ctx, side, top, bottom, frames: int):
    """The sequential render_frame chain's last equirect after ``frames``
    frames (frame 0 priorless, the rest temporal)."""
    from .render.panorama import render_frame

    state, ref = None, None
    for _ in range(frames):
        ref, state = render_frame(ctx, side, top, bottom, state=state,
                                  use_temporal=state is not None)
    return ref["equirect"]


def dryrun_multichip(n_devices: int, device="cuda") -> tuple[float, float]:
    """The frame-batch render step over an n-device (data, ring) mesh
    (frames data-parallel, the camera ring split with the one overlap
    exchange) on tiny shapes: two temporal steps chained through the
    returned states, shard 0's second-step frame 1 within 1e-4 of the
    sequential chain; then the (data 1, ring 14) mesh, within 1e-4 of it.
    Prints one line and returns the two max-abs errors; raises
    ``AssertionError`` when a mesh diverges."""
    from .parallel.mesh import make_render_mesh, shard_frame_batch, sharded_render_step

    dev = resolve_device(str(device))
    devices = [dev] * max(n_devices, 14)
    # the largest ring axis dividing the 14-camera ring; the rest is data
    mesh = make_render_mesh(devices[:n_devices], num_side_cams=14)
    dp = mesh.shape["data"]

    ctx, side, top, bottom = _make_inputs(0.03125, 140, 70, dev)
    F = dp * 2  # frames: 2 per data shard
    frames_side = side.expand((F,) + side.shape)
    frames_top = top.expand((F,) + top.shape)
    frames_bottom = bottom.expand((F,) + bottom.shape)

    # chunked-sequential temporal semantics: each data shard renders its
    # chunk of frames in order, carrying the flow-prior state
    step, _ = sharded_render_step(ctx, mesh, use_temporal=True)
    sharded = shard_frame_batch(mesh, frames_side)
    outputs, states = step(sharded, frames_top, frames_bottom, None)
    out = outputs["equirect"]
    if out.shape[0] != F or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"mesh output {tuple(out.shape)}: {F} finite frames expected")
    # the per-shard states continue each chain: shard 0's chunk is frames
    # [0, 2), so its second-step frames are the chain's frames 2 and 3
    out2 = step(sharded, frames_top, frames_bottom, states)[0]["equirect"]
    ref = _chain(ctx, side, top, bottom, 4)
    err = float((out2[1] - ref).abs().max())
    if not err < DRYRUN_TOL:
        raise AssertionError(f"cross-batch chained output diverges from the sequential "
                             f"chain: max abs err {err}")

    # the camera-width ring: one camera a member, a 14-way overlap exchange
    mesh14 = make_render_mesh(devices[:14], data_parallel=1)
    step14, _ = sharded_render_step(ctx, mesh14, use_temporal=True)
    out14 = step14(shard_frame_batch(mesh14, frames_side[:2]), frames_top[:2],
                   frames_bottom[:2], None)[0]["equirect"]
    ref14 = _chain(ctx, side, top, bottom, 2)
    err14 = float((out14[1] - ref14).abs().max())
    if not err14 < DRYRUN_TOL:
        raise AssertionError(f"ring=14 chained output diverges from the sequential chain: "
                             f"max abs err {err14}")
    print(
        f"dryrun_multichip OK: {n_devices} devices, mesh {mesh.shape}, "
        f"output {tuple(out.shape)}, temporal chain across 2 steps, "
        f"chained-vs-sequential max err {err:.2e}; camera-width ring mesh "
        f"{mesh14.shape} chained max err {err14:.2e}"
    )
    return err, err14
