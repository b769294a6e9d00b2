"""Report: are the ring's pair flows independent of how the pairs are
batched, and what do batch-invariant products cost a frame? On the card.

    python tests/report_batch_invariance.py [--preset 6k] [--groups 3]

Prints (1) the max-abs difference between the side pair flows of ring
slices (one pair, two, seven) computed alone and the same pairs in the
whole 14-pair batch, with the port's products (``ops/resize.py::
matmul_batched``: one image a batch entry) and with products that fold the
batch into a GEMM dimension (what the port ran before); and (2) seconds a
temporal frame of ``render_frame`` at the preset, the two kinds of product
alternated in groups of 3 frames (port, folded, folded, port, ...), with
each run's times and the medians. Imports no JAX; needs CUDA.
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
from surround360_tpu_torch.render import panorama as P  # noqa: E402
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="6k")
    p.add_argument("--groups", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rig = make_ring_rig()
    inputs, _ = cs._render_inputs(rig, dev)
    ctx = P.build_render_context(rig, preset_config(args.preset))

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
              f"{statistics.median(t):.4f} s, runs {[round(x, 4) for x in t]}", flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
