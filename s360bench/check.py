"""The check that decides ``correct``: the program's delivered frames and
temporal states against the plain reference (``reference/``).

The reference renders each checked frame again from the same inputs (the
feed's pool; in raw footage through its own ISP): frame 0 without a prior
from nothing the program made, and each checked window frame from the
program's temporal state of the frame before it, since a frame depends on
the whole chain. Three numbers are compared:

- ``start_inputs_rel``: frame 0's state tensors made before any flow
  (the ring's overlap strips and the fisheye strips: the projection and
  the static warps), the largest ||program - reference|| / ||reference||;
- ``chain_rms_levels``: the worst checked window frame's root mean square
  difference, in 8-bit levels, between the delivered stereo equirect and
  the reference's, quantized alike;
- ``chain_state_rel``: the worst checked window frame's new temporal
  state, as the largest relative difference of one of its tensors (so a
  step that returns its state unchanged shows).

Frame 0's delivered frame and its flows are printed beside them and not
compared: a frame without a prior turns the kernels' last-bit
differences into flows a pixel apart in places, and neither separates
sound runs from the precision control (``PERF.md``); the window never
takes that path.
"""

from __future__ import annotations

import math
import sys

import torch

from .feed import quantize8

HUGE = 1e30  # stands for a missing or non-finite reading
# frame 0's state tensors made before any flow: the ring's overlap strips
# and the fisheye strips, as the next frame's flow prior reads them
INPUT_KEYS = ("prev_overlap_l", "prev_overlap_r", "prev_fish")


def state_gap(program: dict, reference: dict) -> dict:
    """The program's temporal state against the reference's: ``whole``,
    ||program - reference|| / ||reference|| over all its tensors together
    (the flows, in pixels, weigh most); ``worst``, the largest of that
    ratio per tensor, and its ``key``; ``each``, the ratio per tensor."""
    if set(program) != set(reference):
        return dict(whole=HUGE, worst=HUGE, key="keys", each={})
    each, num2, den2 = {}, 0.0, 0.0
    for key, ref in reference.items():
        a, b = program[key].to(ref.device).double(), ref.double()
        if a.shape != b.shape:
            return dict(whole=HUGE, worst=HUGE, key=key, each={})
        both = torch.isnan(a) & torch.isnan(b)  # NaN where both have it agrees
        a, b = torch.where(both, 0.0, a), torch.where(both, 0.0, b)
        num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
        rel = num / den if den > 0 else num
        each[key] = rel if math.isfinite(rel) else HUGE
        num2, den2 = num2 + num * num, den2 + den * den
    whole = math.sqrt(num2 / den2) if den2 > 0 else math.sqrt(num2)
    key = max(each, key=each.get) if each else ""
    return dict(whole=whole if math.isfinite(whole) else HUGE,
                worst=each.get(key, 0.0), key=key, each=each)


def frame_gap(delivered: torch.Tensor, reference_eq: torch.Tensor) -> dict:
    """Root mean square, largest and share over 2 levels of the difference
    between a delivered 8-bit frame and the reference's equirect."""
    ref = quantize8(reference_eq).float()
    if tuple(delivered.shape) != tuple(ref.shape):
        return dict(rms=HUGE, max=HUGE, over2=1.0, nan=0)
    d = delivered.to(ref.device).float() - ref
    rms = float(torch.sqrt(torch.mean(d * d)))
    return dict(rms=rms if math.isfinite(rms) else HUGE, max=float(d.abs().max()),
                over2=float((d.abs() > 2).float().mean()),
                nan=int(torch.isnan(reference_eq).sum()))


def judge(cell, stream, checks, device) -> tuple:
    """Render each checked frame with the reference and compare. Returns
    ({name: {"value", "limit"}}, checked frames over a limit)."""
    from .reference.system import Reference

    ref = Reference(cell.config, device)
    worst = {"start_inputs_rel": 0.0, "chain_rms_levels": 0.0, "chain_state_rel": 0.0}
    failed = 0
    with torch.no_grad():
        for k, state_in, state_out, delivered in checks:
            side, top, bottom = stream.inputs(k, system=ref)
            if state_in is None:
                out, state = ref.first(side, top, bottom)
            else:
                state_in = {key: v.to(device) for key, v in state_in.items()}
                out, state = ref.next(side, top, bottom, state_in)
            gap = frame_gap(delivered, out["equirect"])
            st = state_gap(state_out, state)
            each = " ".join(f"{n} {v:.3g}" for n, v in sorted(st["each"].items()))
            print(f"frame {k}: rms {gap['rms']:.6g} levels, max {gap['max']:.0f}, "
                  f"over 2 levels {gap['over2']:.3g}, reference NaN {gap['nan']}; "
                  f"state whole {st['whole']:.6g}, worst {st['worst']:.6g} ({st['key']}); "
                  f"{each}", file=sys.stderr, flush=True)
            if state_in is None:
                inputs = [v for n, v in st["each"].items() if n.endswith(INPUT_KEYS)]
                now = {"start_inputs_rel": max(inputs) if inputs else HUGE}
            else:
                now = {"chain_rms_levels": gap["rms"], "chain_state_rel": st["worst"]}
            if any(v > cell.limits[n] for n, v in now.items()):
                failed += 1
            for n, v in now.items():
                worst[n] = max(worst[n], v)
            del out, state, state_in
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in worst.items()}, failed
