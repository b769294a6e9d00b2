"""Report: are the ring's pair flows independent of how the pairs are
batched, and what do batch-invariant products cost a frame? On the card.

    python tests/report_batch_invariance.py [--preset 6k] [--groups 3]

Prints (0) every call of a frame 0 and a temporal frame that reaches the
convolution paths (``ops/resize.py::conv_separable_1d`` and
``_double_axis_cubic``, taken at axes >= ``CONV_MIN_AXIS``), by stage:
inside the stages that ``parallel/mesh.py`` splits over the ring (the
side projections, pair flows and chunk renders) or after them, with the
shapes and the count of ring-stage calls whose leading batch is above one
(cuDNN picks a convolution's algorithm by its shape, as cuBLAS a GEMM's);
and the (data 1, ring 14) mesh's two chained frames on the card repeated
against the sequential chain, max-abs; (1) the max-abs difference between the side pair flows of ring
slices (one pair, two, seven) computed alone and the same pairs in the
whole 14-pair batch, with the port's products (``ops/resize.py::
matmul_batched``: one image a batch entry) and with products that fold the
batch into a GEMM dimension (what the port ran before); and (2) seconds a
temporal frame of ``render_frame`` at the preset, the two kinds of product
alternated in groups of 3 frames (port, folded, folded, port, ...), with
each run's times and the medians (``--groups 0`` skips it). Imports no
JAX; needs CUDA.
"""

import argparse
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from surround360_tpu_torch.benchmarks.preset_table import preset_config  # noqa: E402
from surround360_tpu_torch.geometry.rig import make_ring_rig  # noqa: E402
from surround360_tpu_torch.ops import filters, resize  # noqa: E402
from surround360_tpu_torch.parallel.mesh import (  # noqa: E402
    make_render_mesh,
    sharded_render_step,
)
from surround360_tpu_torch.render import panorama as P  # noqa: E402
from surround360_tpu_torch.utils.math_util import disable_tf32  # noqa: E402
from surround360_tpu_torch.views import novel_view  # noqa: E402

SLICES = ((0, 1), (13, 14), (0, 2), (4, 6), (0, 7))


def folded(left, img, right):
    """The products as the port ran them before: the batch folded into the
    GEMM's columns or rows (torch.matmul broadcasting)."""
    out = img
    if left is not None:
        out = torch.matmul(left, out)
    if right is not None:
        out = torch.matmul(out, right)
    return out


PRODUCTS = {"batch entries": resize.matmul_batched, "folded": folded}


def use(name):
    for module in (resize, filters, novel_view):
        module.matmul_batched = PRODUCTS[name]


def conv_calls(ctx, inputs, dev):
    """(name, stage, input shape) of every call reaching a convolution
    path in frame 0 and one temporal frame."""
    calls, stage = [], ["after the ring"]

    def counted(name, fn):
        def call(img, *args, **kw):
            calls.append((name, stage[0], tuple(img.shape)))
            return fn(img, *args, **kw)
        return call

    def in_ring(fn):
        def call(*args, **kw):
            stage[0] = "ring"
            try:
                return fn(*args, **kw)
            finally:
                stage[0] = "after the ring"
        return call

    patches = [(resize, "conv_separable_1d"), (filters, "conv_separable_1d"),
               (resize, "_double_axis_cubic"), (P, "_project_side_cameras"),
               (P, "_render_ring_range")]
    saved = [getattr(m, n) for m, n in patches]
    for (module, name), fn in zip(patches, saved):
        wrap = in_ring(fn) if module is P else counted(name, fn)
        setattr(module, name, wrap)
    try:
        _, state = P.render_frame(ctx, *inputs)
        P.render_frame(ctx, *inputs, state=state, use_temporal=True)
        cs._sync(dev)
    finally:
        for (module, name), fn in zip(patches, saved):
            setattr(module, name, fn)
    return calls


def mesh_vs_chain(ctx, inputs, dev):
    """Max-abs of the (data 1, ring 14) mesh's two chained frames (one
    card repeated) against the sequential render_frame chain, and the
    seconds of each."""
    side, top, bottom = inputs
    t0 = time.perf_counter()
    chain, state = [], None
    for _ in range(2):
        out, state = P.render_frame(ctx, side, top, bottom, state=state,
                                    use_temporal=state is not None)
        chain.append(out["equirect"])
    cs._sync(dev)
    chain_s = time.perf_counter() - t0
    step, _ = sharded_render_step(ctx, make_render_mesh([dev] * 14, data_parallel=1),
                                  use_temporal=True)
    t0 = time.perf_counter()
    mesh = step(side.expand((2,) + side.shape), top.expand((2,) + top.shape),
                bottom.expand((2,) + bottom.shape), None)[0]["equirect"]
    cs._sync(dev)
    mesh_s = time.perf_counter() - t0
    err = max(float((mesh[i] - chain[i]).abs().max()) for i in range(2))
    return err, chain_s, mesh_s


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="6k")
    p.add_argument("--groups", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs CUDA")
    disable_tf32()
    dev = torch.device("cuda", 0)
    rig = make_ring_rig()
    inputs, _ = cs._render_inputs(rig, dev)
    ctx = P.build_render_context(rig, preset_config(args.preset))

    calls = conv_calls(ctx, inputs, dev)
    ring = [c for c in calls if c[1] == "ring"]
    batched = [c for c in ring if len(c[2]) > 3 and c[2][0] > 1]
    shapes = sorted({c for c in calls})
    print(f"[conv] {args.preset}: {len(calls)} calls reach the convolution paths in frame 0 "
          f"and a temporal frame, {len(ring)} inside the ring-split stages, {len(batched)} "
          f"of them with a leading batch > 1; (path, stage, shape): {shapes}", flush=True)
    err, chain_s, mesh_s = mesh_vs_chain(ctx, inputs, dev)
    print(f"[mesh] {args.preset}: (1, 14) mesh on the card repeated vs the sequential chain, "
          f"2 chained frames: max-abs {err:.3g}; chain {chain_s:.3f} s, mesh {mesh_s:.3f} s",
          flush=True)

    proj = P._project_side_cameras(ctx, inputs[0])
    ov = ctx.overlap_w
    ol, orr = proj[..., ctx.strip_w - ov:], torch.roll(proj, -1, 0)[..., :ov]
    for name in PRODUCTS:
        use(name)
        whole = P._side_pair_flows(ctx, ol, orr, {}, False)
        diffs = {}
        for k0, k1 in SLICES:
            part = P._side_pair_flows(ctx, ol[k0:k1], orr[k0:k1], {}, False)
            diffs[f"{k0}:{k1}"] = max(float((whole[i][k0:k1] - part[i]).abs().max())
                                      for i in (0, 1))
        print(f"[slices] {name}: flow max-abs of each slice alone vs in the 14-pair "
              f"batch {diffs}", flush=True)
    del proj, ol, orr

    def frames(n, state):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            _, state = P.render_frame(ctx, *inputs, state=state, use_temporal=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times, state

    use("batch entries")
    if args.groups > 0:
        _, state = P.render_frame(ctx, *inputs)
        _, state = frames(2, state)
        times = {name: [] for name in PRODUCTS}
        for name in ["batch entries", "folded", "folded", "batch entries"] * args.groups:
            use(name)
            t, state = frames(3, state)
            times[name] += t
        use("batch entries")
        for name, t in times.items():
            print(f"[frame] {args.preset} temporal, products as {name}: median "
                  f"{statistics.median(t):.4f} s, runs {[round(x, 4) for x in t]}",
                  flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
