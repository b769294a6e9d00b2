"""The port's multi-device renderer (surround360_tpu_torch/parallel/mesh.py)
on meshes of the CPU repeated, the cases of tests/test_parallel.py: the
mesh's shapes and its refusal of a ring that does not divide the cameras,
a frame batch, rings of 7 and 14 members, the chunked-sequential temporal
chain and its continuation across batches, each held to render_frame on
one device within 1e-4 (the reference's bound; measured 0: every member
runs the single-device arithmetic on its slice); one batch against the
JAX package's own sharded step on 8 virtual devices, full-sphere PSNR >=
40 dB (tests/test_torch_render.py's bound for port against JAX); a ring
member's pairs alone giving the whole ring's flows bit for bit (on the
card a product that folds 2 pairs into its rows rounds apart from one
that folds 14, and the flow solver turns 1e-7 into pixels, so the ring's
products keep one image a batch entry); and the shared launch counter and
plan cache under concurrent threads.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.capture import render_camera_views
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig
from surround360_tpu.parallel import mesh as JM
from surround360_tpu.render import panorama as JP
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops import fused_window as fw
from surround360_tpu_torch.parallel import (
    make_render_mesh,
    shard_frame_batch,
    sharded_render_step,
)
from surround360_tpu_torch.parallel.mesh import ShardedFrames
from surround360_tpu_torch.render import panorama as TP
from surround360_tpu_torch.render.panorama import (
    RenderConfig,
    build_render_context,
    render_frame,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
TOL = 1e-4
PSNR_MIN = 40.0


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def scene():
    rig = make_ring_rig().rescaled(0.03125)
    ctx = build_render_context(rig, RenderConfig(eqr_width=140, eqr_height=70,
                                                 side_flow_alg="pixflow_tpu"))
    views = render_camera_views(jax_rig().rescaled(0.03125))
    side = torch.from_numpy(np.stack([views[rig.ids.index(s)] for s in rig.side_ids]))
    single, _ = render_frame(ctx, side)
    return ctx, side, single["equirect"]


def test_ring_axis_divides_cameras():
    mesh = make_render_mesh([CPU] * 8, num_side_cams=14)
    assert mesh.shape["ring"] in (1, 2, 7, 14)
    assert mesh.shape["data"] * mesh.shape["ring"] == 8


@pytest.mark.parametrize("n,dp,shape", [(8, 4, (4, 2)), (14, None, (1, 14)),
                                        (14, 2, (2, 7)), (3, None, (3, 1))])
def test_explicit_and_default_shapes(n, dp, shape):
    mesh = make_render_mesh([CPU] * n, data_parallel=dp)
    assert mesh.shape == {"data": shape[0], "ring": shape[1]}
    assert all(d == CPU for row in mesh.devices for d in row)


@pytest.mark.parametrize("n,dp", [(8, 2), (8, 3)])
def test_invalid_mesh_rejected(n, dp):
    with pytest.raises(AssertionError):
        make_render_mesh([CPU] * n, data_parallel=dp)  # ring 4; 8 % 3


def test_default_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_render_mesh()


def test_shard_frame_batch_places_chunks():
    mesh = make_render_mesh([CPU] * 14, data_parallel=2)
    frames = torch.arange(4 * 14, dtype=torch.float32).reshape(4, 14, 1, 1, 1)
    sharded = shard_frame_batch(mesh, frames)
    assert isinstance(sharded, ShardedFrames) and sharded.num_frames == 4
    assert len(sharded.shards) == 2 and len(sharded.shards[0]) == 7
    torch.testing.assert_close(sharded.shards[1][3], frames[2:4, 6:8])
    assert shard_frame_batch(mesh, sharded) is sharded
    with pytest.raises(ValueError):
        shard_frame_batch(mesh, frames[:3])


def test_frame_batch_renders_and_matches_single(scene):
    ctx, side, single = scene
    mesh = make_render_mesh([CPU] * 8, num_side_cams=14)
    F = mesh.shape["data"] * 2
    step, cam_sharding = sharded_render_step(ctx, mesh)
    assert cam_sharding.spec == ("data", "ring")
    outputs, states = step(shard_frame_batch(mesh, side.expand((F,) + side.shape)),
                           None, None, None)
    assert outputs["equirect"].shape[0] == F
    assert states["pair_flow_ltr"].shape[:2] == (F, 14)
    for f in range(F):
        assert float((outputs["equirect"][f] - single).abs().max()) <= TOL


@pytest.mark.parametrize("n_dev", [7, 14])
def test_ring_matches_single_device(scene, n_dev):
    """Rings of 7 (2 cameras a member) and 14 (1 a member): the exchange of
    the neighbour's overlap strip gives the single-device render."""
    ctx, side, single = scene
    mesh = make_render_mesh([CPU] * n_dev, num_side_cams=14)
    assert mesh.shape == {"data": 1, "ring": n_dev}
    step, _ = sharded_render_step(ctx, mesh)
    outputs, _ = step(side[None], None, None, None)
    assert float((outputs["equirect"][0] - single).abs().max()) <= TOL


def test_chunked_sequential_matches_single_device_chain(scene):
    """use_temporal=True on a (data 2, ring 7) mesh: each shard renders its
    2-frame chunk carrying the prior; fed back, the returned per-shard
    states continue each shard's chain in the next batch. Both batches
    equal the sequential single-device chain frame for frame."""
    ctx, side, _ = scene
    mesh = make_render_mesh([CPU] * 14, data_parallel=2)
    dp, c = 2, 2
    F = dp * c
    gains = (0.8 + 0.4 * np.arange(F) / (F - 1)).astype(np.float32)
    frames = torch.stack([torch.cat([side[:, :3] * float(g), side[:, 3:]], 1) for g in gains])
    step, _ = sharded_render_step(ctx, mesh, use_temporal=True)
    out1, states = step(frames, None, None, None)
    assert isinstance(states, list) and len(states) == dp
    out2, _ = step(frames, None, None, states)
    for d in range(dp):
        st = None
        for batch, out in enumerate((out1, out2)):
            for i in range(c):
                f = d * c + i
                ref, st = render_frame(ctx, frames[f], state=st, use_temporal=st is not None)
                err = float((out["equirect"][f] - ref["equirect"]).abs().max())
                assert err <= TOL, f"shard {d} batch {batch} frame {i}: {err}"


def test_matches_jax_sharded_step(scene):
    """A 4-frame batch on the (data 4, ring 2) mesh of 8 devices in both
    packages: each frame within PSNR_MIN of JAX's."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    ctx, side, _ = scene
    jrig = jax_rig().rescaled(0.03125)
    jctx = JP.build_render_context(jrig, JP.RenderConfig(
        eqr_width=140, eqr_height=70, side_flow_alg="pixflow_tpu"))
    gains = np.float32([0.8, 0.9, 1.0, 1.1])
    frames = np.stack([np.concatenate([side.numpy()[:, :3] * g, side.numpy()[:, 3:]], 1)
                       for g in gains])
    jmesh = JM.make_render_mesh(jax.devices()[:8], num_side_cams=14)
    jstep, _ = JM.sharded_render_step(jctx, jmesh)
    want, _ = jstep(JM.shard_frame_batch(jmesh, jnp.asarray(frames)), None, None, None)
    mesh = make_render_mesh([CPU] * 8, num_side_cams=14)
    assert mesh.shape == dict(jmesh.shape)
    step, _ = sharded_render_step(ctx, mesh)
    got, _ = step(torch.from_numpy(frames), None, None, None)
    want = np.asarray(want["equirect"])
    for f in range(len(gains)):
        assert psnr(got["equirect"][f].numpy(), want[f]) >= PSNR_MIN, f


def _hammer(fn, threads=16):
    """Run fn on ``threads`` threads at once with a short switch interval;
    every join is bounded."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(threads)
        errors = []

        def run():
            try:
                barrier.wait(timeout=30)
                fn()
            except Exception as e:  # reported below
                errors.append(e)

        pool = [threading.Thread(target=run) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
        assert not errors, errors
    finally:
        sys.setswitchinterval(interval)


def test_launch_counts_survive_threads(monkeypatch):
    """The mesh's threads count launches into one Counter: no update lost."""
    monkeypatch.setattr(fw, "LAUNCHES", type(fw.LAUNCHES)())
    _hammer(lambda: [fw._count(fw.K1, "side_projection") for _ in range(2000)])
    assert fw.launch_count(fw.K1) == 16 * 2000


def test_static_plan_built_once_across_threads(scene, monkeypatch):
    """Threads asking one context for the same plan build it once."""
    ctx, side, _ = scene
    built = []

    def plan(*args):
        built.append(args[1:])
        return object()

    monkeypatch.setattr(TP, "plan_static_remap", plan)
    monkeypatch.setattr(ctx, "plans", {})
    results = []
    _hammer(lambda: results.append(ctx.static_plan("side", (8, 8), CPU, (0, 2))))
    assert len(built) == 1 and len(set(map(id, results))) == 1


def test_pair_flows_do_not_depend_on_the_batch(scene):
    """Two pairs, or one, alone give the pair flows, their state and the
    chunks of the whole ring's batch bit for bit: the ring path's products
    are strided-batched, one image a batch entry, and its image sums run
    image by image (ops/resize.py::matmul_batched, per_image), so a ring
    member's smaller batch cannot round apart from render_frame's."""
    ctx, side, _ = scene
    proj = TP._project_side_cameras(ctx, side)
    ov = ctx.overlap_w
    ol, orr = proj[..., ctx.strip_w - ov:], torch.roll(proj, -1, 0)[..., :ov]
    whole = TP._side_pair_flows(ctx, ol, orr, {}, False)
    part = TP._side_pair_flows(ctx, ol[4:6], orr[4:6], {}, False)
    one = TP._side_pair_flows(ctx, ol[5:6], orr[5:6], {}, False)
    assert torch.equal(whole[0][5:6], one[0]) and torch.equal(whole[1][5:6], one[1])
    assert torch.equal(whole[0][4:6], part[0]) and torch.equal(whole[1][4:6], part[1])
    for key in whole[2]:
        assert torch.equal(whole[2][key][4:6], part[2][key]), key
    chunks = TP._render_ring_range(ctx, proj, proj[0, ..., :ov], {}, False)
    chunks_part = TP._render_ring_range(ctx, proj[4:6], proj[6, ..., :ov], {}, False)
    assert torch.equal(chunks[0][4:6], chunks_part[0])
    assert torch.equal(chunks[1][4:6], chunks_part[1])
