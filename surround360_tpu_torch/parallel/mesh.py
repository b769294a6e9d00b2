"""Multi-device rendering over a (data, ring) grid of torch devices.

Port of ``surround360_tpu/parallel/mesh.py``. The reference's parallelism
is pthread fan-out per camera / pair / eye on one CPU (SURVEY §2.10); the
JAX package annotates shardings and lets XLA partition ``render_frame``.
PyTorch has no partitioner, so the split is placed here by hand:

- **ring axis**: ring member k of a data shard takes side cameras
  [k N / r, (k + 1) N / r): it projects them on its device, receives the
  first overlap columns of member k + 1's first projection (one strip
  copied with ``.to(device)``: the counterpart of the reference's
  collective permute, ``jnp.roll(projections, -1)`` over a sharded camera
  dim, and the only exchange), and runs the pair flows and chunk renders
  of its pairs with its slice of the ring state. The chunks and state
  slices are gathered on the shard's lead device (its member 0), which
  stitches the ring and renders the poles and the outputs.
- **data axis**: video frames are embarrassingly parallel apart from the
  temporal flow prior; each data shard renders a contiguous chunk of
  frames, carrying the prior inside its chunk (chunked-sequential
  semantics). The shards run concurrently, one host thread each (CUDA
  launches are asynchronous and PyTorch releases the interpreter lock in
  its kernels); a shard's ring members run on one thread for each
  distinct device among them, in turn where they share one.

A device may appear more than once in the grid: ``[torch.device("cpu")] *
8`` or ``[cuda:0] * 14`` stand for a mesh of distinct devices, as the JAX
tests use virtual CPU devices.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from ..render.panorama import (
    RenderContext,
    _project_side_cameras,
    _render_after_ring,
    _render_ring_range,
    _stitch_ring,
)
from ..utils.math_util import disable_tf32

__all__ = ["make_render_mesh", "shard_frame_batch", "sharded_render_step"]

# ring-state keys, one row per camera pair (the pole keys belong to the lead)
_PAIR_KEYS = ("pair_flow_ltr", "pair_flow_rtl", "prev_overlap_l", "prev_overlap_r")


@dataclass(frozen=True)
class RenderMesh:
    """A (data, ring) grid of devices; ``devices[d][k]`` is ring member k of
    data shard d, and ``devices[d][0]`` the shard's lead device."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "ring": len(self.devices[0])}


@dataclass(frozen=True)
class Sharding:
    """Which mesh axes split which leading dims of an array, as
    ``NamedSharding(mesh, PartitionSpec(*spec))`` says in the reference."""

    mesh: RenderMesh
    spec: tuple


@dataclass(frozen=True)
class ShardedFrames:
    """A (F, N, 4, H, W) frame batch placed on a mesh: ``shards[d][k]``
    holds data chunk d's frames of ring member k's cameras, on that
    member's device."""

    mesh: RenderMesh
    shards: tuple

    @property
    def num_frames(self) -> int:
        return sum(chunk[0].shape[0] for chunk in self.shards)


def make_render_mesh(devices=None, data_parallel: int | None = None,
                     num_side_cams: int = 14) -> RenderMesh:
    """Mesh over (data, ring). The ring axis must divide the side-camera
    count (14 -> ring in {1, 2, 7, 14}); with no hints, pick the largest
    valid ring (intra-frame parallelism, lowest per-frame latency) and put
    the rest on ``data`` (frame throughput). ``devices=None`` takes every
    visible CUDA device and raises without one; devices may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_render_mesh: no CUDA device (pass devices= to "
                               "build a mesh of other devices)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data_parallel is None:
        ring = 1
        for cand in range(1, num_side_cams + 1):
            if num_side_cams % cand == 0 and n % cand == 0:
                ring = cand
        dp = n // ring
    else:
        dp = data_parallel
        if n % dp:
            raise AssertionError(f"{n} devices not divisible by data_parallel={dp}")
        ring = n // dp
        if num_side_cams % ring:
            raise AssertionError(
                f"ring axis {ring} must divide the {num_side_cams}-camera ring"
            )
    return RenderMesh(tuple(tuple(devices[d * ring:(d + 1) * ring]) for d in range(dp)))


def shard_frame_batch(mesh: RenderMesh, frames_side_images) -> ShardedFrames:
    """Place a frame batch (F, N, 4, H, W) with frames on ``data`` and the
    camera ring on ``ring``. F must divide by the data axis and N by the
    ring axis."""
    if isinstance(frames_side_images, ShardedFrames):
        return frames_side_images
    frames = torch.as_tensor(frames_side_images)
    dp, ring = mesh.shape["data"], mesh.shape["ring"]
    F, N = frames.shape[:2]
    if F % dp or N % ring:
        raise ValueError(f"a batch of {F} frames x {N} cameras does not split over "
                         f"a mesh of {mesh.shape}")
    c, m = F // dp, N // ring
    return ShardedFrames(mesh, tuple(
        tuple(frames[d * c:(d + 1) * c, k * m:(k + 1) * m].to(dev)
              for k, dev in enumerate(row))
        for d, row in enumerate(mesh.devices)
    ))


def _each_member(fn, devices, pool: ThreadPoolExecutor) -> list:
    """[fn(k) for each ring member k]: one task a distinct device, which
    runs its members in turn (threads on one device would only contend for
    the interpreter: the flow solvers are launch-bound)."""
    groups: dict = {}
    for k, dev in enumerate(devices):
        groups.setdefault(dev, []).append(k)
    out = [None] * len(devices)

    def run(members):
        for k in members:
            out[k] = fn(k)

    list(pool.map(run, groups.values()))
    return out


def _render_frame_on_shard(ctx: RenderContext, devices, sides, top, bottom, state,
                           use_temporal: bool, pool: ThreadPoolExecutor):
    """One frame on one data shard: ``sides[k]`` (n, 4, H, W) are ring
    member k's cameras on ``devices[k]``; top, bottom and the state on the
    lead device. Returns (outputs, new state) on the lead device."""
    lead, ring = devices[0], len(devices)
    m = sides[0].shape[0]
    state = state or {}

    projections = _each_member(lambda k: _project_side_cameras(ctx, sides[k], k * m),
                               devices, pool)
    ov = ctx.overlap_w
    # the one exchange: member k + 1's first overlap strip to member k
    strips = [projections[(k + 1) % ring][0, ..., :ov].to(devices[k]) for k in range(ring)]

    def member(k):
        st = {key: state[key][k * m:(k + 1) * m].to(devices[k])
              for key in _PAIR_KEYS if key in state}
        return _render_ring_range(ctx, projections[k], strips[k], st, use_temporal)

    parts = _each_member(member, devices, pool)
    del projections, strips
    chunks_l = torch.cat([p[0].to(lead) for p in parts])
    chunks_r = torch.cat([p[1].to(lead) for p in parts])
    ring_state = {key: torch.cat([p[2][key].to(lead) for p in parts]) for key in parts[0][2]}
    del parts
    pano_l, pano_r = _stitch_ring(ctx, chunks_l, chunks_r)
    return _render_after_ring(ctx, pano_l, pano_r, ring_state, top, bottom, state,
                              use_temporal)


def sharded_render_step(ctx: RenderContext, mesh: RenderMesh, use_temporal: bool = False):
    """A frame-batch render step over ``mesh``; returns (step, cam_sharding)
    with cam_sharding the ("data", "ring") placement of the side frames.

    step(frames_side (F, N, 4, H, W) tensor or :func:`shard_frame_batch`'s
    result, frames_top (F, 4, H, W) | None, frames_bottom | None, state) ->
    (outputs with leading F on the mesh's first device, states). F must be
    divisible by the ``data`` axis, N by the ``ring`` axis.

    use_temporal=False renders every frame alone and returns the per-frame
    states stacked on a leading F, as the reference's ``vmap`` does.

    use_temporal=True gives chunked-sequential semantics, matching the
    reference's frame chain (TestRenderStereoPanorama.cpp:210-256): each
    data shard takes a contiguous chunk of frames and renders it in order,
    carrying the flow-prior state; the chain breaks only at chunk
    boundaries. The states come back as a list of one state dict per data
    shard, on the shard's lead device: the torch form of the reference's
    pytree with a leading data-axis dim. ``state`` may be such a list from
    a previous step, which continues each shard's chain across batches;
    with state=None each shard's first frame renders priorless (like the
    reference's frame 0)."""
    dp, ring = mesh.shape["data"], mesh.shape["ring"]
    cam_sharding = Sharding(mesh, ("data", "ring"))

    def step(frames_side, frames_top, frames_bottom, state):
        disable_tf32()  # render_frame's precision (the reference is float32)
        sharded = shard_frame_batch(mesh, frames_side)
        F = sharded.num_frames
        c = F // dp
        if state is not None and len(state) != dp:
            raise ValueError(f"{len(state)} shard states for a data axis of {dp}")

        def chunk(frames, d):
            if frames is None:
                return [None] * c
            return [f.to(mesh.devices[d][0]) for f in frames[d * c:(d + 1) * c]]

        def shard(d):
            devices = mesh.devices[d]
            tops, bottoms = chunk(frames_top, d), chunk(frames_bottom, d)
            st = None if state is None else state[d]
            outs, states = [], []
            with ThreadPoolExecutor(len(set(devices))) as pool:
                for i in range(c):
                    sides = [s[i] for s in sharded.shards[d]]
                    prior = st if use_temporal else None
                    out, new_st = _render_frame_on_shard(
                        ctx, devices, sides, tops[i], bottoms[i], prior,
                        use_temporal and prior is not None, pool,
                    )
                    outs.append(out)
                    states.append(new_st)
                    st = new_st
            return outs, states

        with ThreadPoolExecutor(dp) as pool:
            results = list(pool.map(shard, range(dp)))
        first = mesh.devices[0][0]
        frames_out = [o for outs, _ in results for o in outs]
        outputs = {key: torch.stack([o[key].to(first) for o in frames_out])
                   for key in frames_out[0]}
        if use_temporal:
            return outputs, [states[-1] for _, states in results]
        per_frame = [s for _, states in results for s in states]
        return outputs, {key: torch.stack([s[key].to(first) for s in per_frame])
                         for key in per_frame[0]}

    return step, cam_sharding
