"""Attribute the non-offsets fused-sampler step cost, component by
component, at the 6k novel-view geometry (K5).

Port of ``benchmarks/kernel_body_cost.py``. The probe runs K1's
non-offsets body (bicubic x and y distance matrices built from the step's
coordinates, the window shifted by a per-step amount and cut to 256 lanes,
one float32 product, the per-channel multiply-reduce) as an (N,)-step
grid with one component stubbed per variant; the stub keeps a per-step
data dependency. ``full`` minus a stubbed variant attributes that
component; ``full_dma`` copies the window from a taller array at a row
that rotates with the step. Per-step time comes from the (N1, N2) = (256,
2048) grid contrast, CUDA events on the card.

Geometry: C = 4 channels x 72 window rows, a 384-lane window cut to 256,
512 samples a step. The reference's ``S360_BODY_C/BH/BW/BWB/PG`` overrides
have no counterpart: the kernel (``csrc/kernel_body_cost.cu``) is compiled
for this geometry. The product is the reference's own ``dot3`` (both
operands split into bfloat16 high and low parts, three products summed in
float32): the kernel takes it on the bf16 tensor cores, its twin
(:func:`body_cost_plain`) in plain PyTorch (:func:`dot3`).

    python -m surround360_tpu_torch.benchmarks.kernel_body_cost [--device cpu]
Env: S360_STEP_REPS (10), S360_BODY_ONLY (one variant).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from .. import cuda_build
from . import probe_common as pc

__all__ = ["VARIANTS", "dot3", "body_cost", "body_cost_plain", "make_inputs",
           "run", "components", "main"]

C, BH, BW, BWB, PG = 4, 72, 384, 256, 512
DMA_ROWS = 64  # extra window rows of full_dma's source (rows rotate by 8)
N1, N2 = 256, 2048
SOURCE = "kernel_body_cost.cu"
SITE = "kernel_body_cost"
_ON = dict(ohx=True, ohy=True, dot=True, reduce=True, roll=True, dma=False)
# the reference's variants, in its order -> the components they run
VARIANTS = {"full": _ON}
VARIANTS.update({f"no_{s}": {**_ON, s: False}
                 for s in ("ohx", "ohy", "dot", "reduce", "roll")})
VARIANTS["full_dma"] = {**_ON, "dma": True}
_INDEX = {name: i for i, name in enumerate(VARIANTS)}  # the C entry's order
_CHUNK = 64  # twin steps at a time


def _check(variant, shifts, xs, ys, win):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant: {variant}")
    n = xs.shape[0] if xs.ndim == 3 else -1
    for name, a in (("xs", xs), ("ys", ys)):
        if a.dtype != torch.float32 or tuple(a.shape) != (n, 1, PG):
            raise ValueError(f"{name} must be (n, 1, {PG}) float32")
    if shifts.dtype != torch.int32 or tuple(shifts.shape) != (n,):
        raise ValueError("shifts must be (n,) int32")
    rows = C * BH + (56 if VARIANTS[variant]["dma"] else 0)
    if win.dtype != torch.float32 or win.ndim != 2 or win.shape[1] != BW or win.shape[0] < rows:
        raise ValueError(f"win must be (>= {rows}, {BW}) float32")


def dot3(a, b):
    """The reference's ``dot3``: a @ b^T (a (..., M, K), b (..., N, K)) with
    both operands split into bfloat16 high and low parts (round to nearest
    even), ah.bh + al.bh + ah.bl, each product in float32."""
    ah = a.to(torch.bfloat16).float()
    al = (a - ah).to(torch.bfloat16).float()
    bh = b.to(torch.bfloat16).float()
    bl = (b - bh).to(torch.bfloat16).float()
    f = lambda p, q: torch.matmul(p, q.transpose(-1, -2))
    return f(ah, bh) + f(al, bh) + f(ah, bl)


def _stub(v, width):
    """The reference's stand-in for a matrix: v[:, None] * 1e-3."""
    return (v[..., None] * 1e-3).expand(*v.shape, width)


def _plain_chunk(t, steps, shifts, x, y, win):
    dev = x.device
    ohx = pc.tent(x[..., None] - torch.arange(BWB, dtype=torch.float32, device=dev)) \
        if t["ohx"] else _stub(x, BWB)
    ohy = pc.tent(y[..., None] - torch.arange(BH, dtype=torch.float32, device=dev)) \
        if t["ohy"] else _stub(y, BH)
    if t["dot"]:
        rows = torch.arange(C * BH, device=dev)[None]
        if t["dma"]:
            rows = rows + (steps % 8 * 8)[:, None]
        shift = shifts.long() if t["roll"] else torch.zeros_like(shifts, dtype=torch.long)
        cols = torch.remainder(torch.arange(BWB, device=dev)[None] - shift[:, None], BW)
        wm = win[rows[:, :, None], cols[:, None, :]]  # (n, C * BH, BWB)
        tmp = dot3(ohx, wm)  # (n, PG, C * BH)
    else:
        tmp = _stub(x, C * BH) + ohx[..., :1]
    if t["reduce"]:
        v = (tmp.reshape(*tmp.shape[:2], C, BH) * ohy[:, :, None, :]).sum(-1)
    else:
        v = tmp[..., ::BH] + ohy[..., :1]
    return v.transpose(1, 2)  # (n, C, PG)


def body_cost_plain(variant, shifts, xs, ys, win):
    """Plain PyTorch twin of the probe kernel ``variant``: shifts (n,) int32
    lane shifts in [0, 384); xs, ys (n, 1, 512) sample coordinates; win
    (288, 384), (>= 344, 384) for full_dma. Returns (n, 4, 512)."""
    _check(variant, shifts, xs, ys, win)
    t = VARIANTS[variant]
    steps = torch.arange(xs.shape[0], device=xs.device)
    return torch.cat([
        _plain_chunk(t, steps[i:i + _CHUNK], shifts[i:i + _CHUNK],
                     xs[i:i + _CHUNK, 0], ys[i:i + _CHUNK, 0], win)
        for i in range(0, xs.shape[0], _CHUNK)
    ]).contiguous()


def body_cost(variant, shifts, xs, ys, win):
    """The probe kernel ``variant`` on the card, or its twin for CPU
    tensors; same arguments as :func:`body_cost_plain`. Counts each launch
    in ``cuda_build.LAUNCHES`` at (:data:`SITE`, variant)."""
    if pc.probe_device(shifts, xs, ys, win) == "cpu":
        return body_cost_plain(variant, shifts, xs, ys, win)
    _check(variant, shifts, xs, ys, win)
    fn = cuda_build.entry(SOURCE, "s360_body_cost", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)
    args = [a.contiguous() for a in (shifts, xs, ys, win)]
    n = xs.shape[0]
    out = torch.empty((n, C, PG), dtype=torch.float32, device=xs.device)
    cuda_build.launch(SITE, variant, fn, args + [out], [n, win.shape[0], _INDEX[variant]],
                      xs.device)
    return out


def make_inputs(rng, variant, n, device):
    """The reference's inputs: shifts in [0, 128), x in [2, 253), y in [2,
    69), the window uniform in [0, 1) ((288 + 64) rows for full_dma)."""
    xs = rng.uniform(2, BWB - 3, (n, 1, PG)).astype(np.float32)
    ys = rng.uniform(2, BH - 3, (n, 1, PG)).astype(np.float32)
    shifts = rng.integers(0, 128, n, np.int32)
    rows = C * BH + (DMA_ROWS if VARIANTS[variant]["dma"] else 0)
    win = rng.random((rows, BW)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (shifts, xs, ys, win))


def components(res: dict) -> dict:
    """The reference's summary: ``full`` and what each component adds
    (full minus the variant without it; dma: full_dma minus full)."""
    if "full" not in res:
        return dict(res)
    out = {"full": res["full"]}
    for name, v in res.items():
        if name.startswith("no_"):
            out[name[3:]] = res["full"] - v
    if "full_dma" in res:
        out["dma"] = res["full_dma"] - res["full"]
    return out


def run(device, reps: int = 10):
    """Per-step us of each variant (only ``S360_BODY_ONLY`` when set) by
    the grid contrast (CUDA events on a CUDA device; the twins on the host
    clock on the CPU). Returns {variant: {"us_per_step", "t1_ms", "t2_ms",
    "steps"}}."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    only = os.environ.get("S360_BODY_ONLY", "")
    out = {}
    for name in [only] if only else VARIANTS:
        def make(n, name=name):
            args = make_inputs(rng, name, n, device)
            return lambda: body_cost(name, *args)

        us, t1, t2 = pc.per_step_us(make, N1, N2, reps, device)
        print(f"{name:24s} {us:8.2f} us/step", flush=True)
        out[name] = {"us_per_step": us, "t1_ms": t1, "t2_ms": t2, "steps": (N1, N2)}
    return out


def main(argv=None):
    from ..cli.common import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"# {torch.cuda.get_device_name(device)}", flush=True)
    res = run(device, int(os.environ.get("S360_STEP_REPS", "10")))
    summary = components({k: r["us_per_step"] for k, r in res.items()})
    print(json.dumps({k: round(v, 2) for k, v in summary.items()}))
    return res


if __name__ == "__main__":
    main()
