"""Attribute a fused-sampler step's cost, component by component (K4).

Port of ``benchmarks/kernel_step_cost.py``. Tiny single-window kernels at
the side-flow level-0 ranking geometry (a window of C = 2 channels x 64
rows x 512 lanes, 512 samples a step) isolate one suspect each:

  dots_x5               5 dense products of a coordinate-scaled iota matrix
                        (512 x 512) with the window, each product's first
                        64 columns summed
  tent_plus_dots_x5     + the bicubic distance-matrix build from the step's
                        512 coordinates, shared by the 5 products
  tent_dots_roll_x5     + the window shifted by o lanes before product o
  lead8_fori            8 leads a step, each a tent build and one product,
  lead8_unrolled          as a runtime loop and unrolled (us per lead)
  tent_dots_dyn_dma_x5  the tent body on window rows copied each step from
                        a taller array at a row that depends on the step

Each variant runs as an (N,)-step grid; per-step time is (t(N2) - t(N1)) /
(N2 - N1) with N = 64 / 4096 (64 / 512 for the lead pair), so launch and
fixed costs cancel. Times are CUDA events on the card.

The kernels are CUDA C++ (``csrc/kernel_step_cost.cu``, three entry points
for the three TPU call sites), built with nvcc at first use; beside each
runs its plain PyTorch twin (:func:`step_cost_plain`), which the wrapper
(:func:`step_cost`) takes for CPU tensors only.

    python -m surround360_tpu_torch.benchmarks.kernel_step_cost [--device cpu]
Env: S360_STEP_REPS (20).
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

__all__ = ["VARIANTS", "STEPS", "step_cost", "step_cost_plain", "make_inputs",
           "run", "main"]

BH, BW, PG, C, N_OX, LEADS, XROWS = 64, 512, 512, 2, 5, 8, 8
BIGH = BH * 4  # rows of the array the dma variant copies its window from
SOURCE = "kernel_step_cost.cu"
SITE_VARIANT, SITE_DYN, SITE_DMA = (
    "kernel_step_cost_variant", "kernel_step_cost_dyn", "kernel_step_cost_dma")
# the reference's names -> (kernel site, body or loop)
VARIANTS = {
    "dots_x5": (SITE_VARIANT, "dots"),
    "tent_plus_dots_x5": (SITE_VARIANT, "tent"),
    "tent_dots_roll_x5": (SITE_VARIANT, "roll"),
    "lead8_fori": (SITE_DYN, "fori"),
    "lead8_unrolled": (SITE_DYN, "unrolled"),
    "tent_dots_dyn_dma_x5": (SITE_DMA, "dma"),
}
STEPS = {name: (64, 512) if name.startswith("lead8") else (64, 4096)
         for name in VARIANTS}
_BODY = {"dots": 0, "tent": 1, "roll": 2}
_CHUNK = 64  # twin steps at a time (a 512 x 512 matrix a step)


def out_rows(variant: str) -> int:
    return LEADS if VARIANTS[variant][0] == SITE_DYN else N_OX


def _check(variant, x, win, big):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant: {variant}")
    if x.dtype != torch.float32 or x.ndim != 3 or tuple(x.shape[1:]) != (XROWS, PG):
        raise ValueError(f"x must be (n, {XROWS}, {PG}) float32, got {tuple(x.shape)}")
    if VARIANTS[variant][0] == SITE_DMA:
        if (big is None or big.dtype != torch.float32 or big.ndim != 3
                or big.shape[0] != C or big.shape[2] != BW or big.shape[1] < BH + 120):
            raise ValueError(f"big must be ({C}, >= {BH + 120}, {BW}) float32")
        return big
    if win is None or win.dtype != torch.float32 or tuple(win.shape) != (C, BH, BW):
        raise ValueError(f"win must be ({C}, {BH}, {BW}) float32")
    return win


def _dma_rows(x0: torch.Tensor) -> torch.Tensor:
    """Window row origins of the dma variant: (int(x0 mod 128) // 8) * 8."""
    return torch.div(torch.remainder(x0, 128.0).to(torch.int64), 8,
                     rounding_mode="floor") * 8


def _summed(oh, w):
    """sum over h of the product oh (n, PG, BW) . w (n or 1, BH, BW)^T."""
    return torch.matmul(oh, w.transpose(-1, -2)).sum(-1)


def _plain_chunk(variant, x, w0, big):
    body = VARIANTS[variant][1]
    k = torch.arange(BW, dtype=torch.float32, device=x.device)
    n = x.shape[0]
    if body == "dots":
        oh = (k * (x[:, 0, 0] * 1e-6)[:, None, None]).expand(n, PG, BW)
        return torch.stack([_summed(oh + float(o), w0) for o in range(N_OX)], 1)
    if body in ("fori", "unrolled"):
        return torch.stack([_summed(pc.tent(x[:, l, :, None] - k), w0)
                            for l in range(LEADS)], 1)
    if body == "dma":
        rows = _dma_rows(x[:, 0, 0])[:, None] + torch.arange(BH, device=x.device)
        w0 = big[0][rows]  # (n, BH, BW)
    oh = pc.tent(x[:, 0, :, None] - k)
    roll = body == "roll"
    return torch.stack([_summed(oh, torch.roll(w0, o, dims=-1) if roll else w0)
                        for o in range(N_OX)], 1)


def step_cost_plain(variant, x, win, big=None):
    """Plain PyTorch twin of the probe kernel ``variant``: x (n, 8, 512);
    win (2, 64, 512) (unused by the dma variant); big (2, >= 184, 512) for
    the dma variant. Returns (n, 5, 512), (n, 8, 512) for the lead pair."""
    src = _check(variant, x, win, big)
    w0 = None if src is big else win[0][None]
    return torch.cat([_plain_chunk(variant, x[i:i + _CHUNK], w0, big)
                      for i in range(0, x.shape[0], _CHUNK)])


def step_cost(variant, x, win, big=None):
    """The probe kernel ``variant`` (see the module docstring) on the card,
    or its twin for CPU tensors; same arguments as :func:`step_cost_plain`.
    Counts each launch in ``cuda_build.LAUNCHES`` at (kernel site, variant)."""
    site, body = VARIANTS.get(variant, (None, None))
    src = big if site == SITE_DMA else win
    kind = pc.probe_device(x, *([] if src is None else [src]))
    if kind == "cpu":
        return step_cost_plain(variant, x, win, big)
    src = _check(variant, x, win, big)
    entry = {SITE_VARIANT: "s360_step_variant", SITE_DYN: "s360_step_dyn",
             SITE_DMA: "s360_step_dma"}[site]
    fn = cuda_build.entry(SOURCE, entry, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    x, src = x.contiguous(), src.contiguous()
    n = x.shape[0]
    out = torch.empty((n, out_rows(variant), PG), dtype=torch.float32, device=x.device)
    arg = {SITE_VARIANT: _BODY.get(body), SITE_DYN: int(body == "unrolled"),
           SITE_DMA: src.shape[1]}[site]
    cuda_build.launch(site, variant, fn, [x, src, out], [n, arg], x.device)
    return out


def make_inputs(rng, variant, n, device):
    """The reference's inputs: coordinates in [2, 506) (8 sublanes a step),
    the window (or, for dma, the taller array) uniform in [0, 1)."""
    x = torch.from_numpy((rng.random((n, XROWS, PG)) * (BW - 8) + 2).astype(np.float32))
    if VARIANTS[variant][0] == SITE_DMA:
        big = torch.from_numpy(rng.random((C, BIGH, BW)).astype(np.float32))
        return x.to(device), None, big.to(device)
    win = torch.from_numpy(rng.random((C, BH, BW)).astype(np.float32))
    return x.to(device), win.to(device), None


def run(device, reps: int = 20):
    """Per-step time of each variant by the grid contrast: on a CUDA device
    the kernels, timed with CUDA events; on the CPU the twins, on the host
    clock. Returns {variant: {"us_per_step", "us_per_lead" (lead pair),
    "t1_ms", "t2_ms", "steps"}}."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    out = {}
    for name in VARIANTS:
        n1, n2 = STEPS[name]

        def make(n, name=name):
            args = make_inputs(rng, name, n, device)
            return lambda: step_cost(name, *args)

        us, t1, t2 = pc.per_step_us(make, n1, n2, reps, device)
        r = {"us_per_step": us, "t1_ms": t1, "t2_ms": t2, "steps": (n1, n2)}
        if VARIANTS[name][0] == SITE_DYN:
            r["us_per_lead"] = us / LEADS
            print(f"{name:28s} {us:8.2f} us/step ({LEADS} leads/step -> "
                  f"{us / LEADS:.2f} us/lead)", flush=True)
        else:
            print(f"{name:28s} {us:8.2f} us/step   (t{n1} {t1:.2f} ms, "
                  f"t{n2} {t2:.2f} ms)", flush=True)
        out[name] = r
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
    res = run(device, int(os.environ.get("S360_STEP_REPS", "20")))
    print(json.dumps({k: round(r.get("us_per_lead", r["us_per_step"]), 2)
                      for k, r in res.items()}))
    return res


if __name__ == "__main__":
    main()
