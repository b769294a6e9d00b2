"""The check that decides ``correct``: the program's delivered frames and
temporal states against the plain reference (``reference/``).

The reference renders each checked frame again from the same inputs (the
feed's pool; in raw footage through its own ISP): a frame without a prior
(frame 0, and every frame of a mix with ``"prior": false``) from nothing
the program made, and each checked chained frame from the program's
temporal state of the frame before it, since such a frame depends on the
whole chain. A frame without a prior is read by:

- ``start_inputs_rel``: its state tensors made before any flow (the
  ring's overlap strips and the fisheye strips: the projection and the
  static warps), the largest ||program - reference|| / ||reference||;
- ``still_ring_flow_p50_px``: its ring's pair flows (the state's
  ``pair_flow_ltr``, ``pair_flow_rtl``), the median over all the ring's
  flow vectors of the length of program - reference, in pixels of the
  flow's grid, the larger of the two directions: a flow solved from zero
  converges elsewhere in places, which the median passes over, while a
  flow that skips a step or computes in a lower precision is off nearly
  everywhere;
- ``still_ring_pair_p25_px``: for each pair and direction alone, the
  first quartile of that length over the pair's vectors, the worst
  pair's: a fault confined to a few pairs, which the ring's median passes
  over, moves it. (A sound pair diverges in its untextured parts, at
  times over more than half of the pair, so its median swings from seed
  to seed: one stills seed in 40 read 13 times the others.)
- ``still_pole_flow_p25_px``: its pole flows (``top_flow``,
  ``bottom_flow``), for each pole the first quartile of that length over
  both eyes' vectors, the larger of the two poles: a sound pole flow
  diverges over much of its untextured sky and ground, which moves its
  median from seed to seed, and agrees closely over the rest;
- ``still_anchored_rms_levels``: the root mean square difference, in
  8-bit levels, between the delivered stereo equirect and the reference's
  render of the same inputs from the program's own new state of that
  frame (``Reference.next``): since that state holds the same images, the
  reference takes the program's flows as they are, and renders everything
  after them itself;
- ``still_rms_levels``: the same difference against the reference's own
  frame without a prior. A frame without a prior turns the kernels'
  last-bit differences into flows a pixel apart in places, and this does
  not separate sound runs from the precision control (``PERF.md``): no
  cell gives it a limit.

A chained frame is read by:

- ``chain_rms_levels``: the root mean square difference, as above,
  against the reference's render from the state before;
- ``chain_state_rel``: its new temporal state, the largest relative
  difference of one of its tensors (so a step that returns its state
  unchanged shows).

Each is the worst over the checked frames. A NaN is never sound: a
frame whose new state holds one, or whose reference frame does, reads
``HUGE`` on every number. A number is compared where the cell's
``limits/<cell>.json`` gives it a limit, and only printed otherwise; a
limit that no checked frame reads fails.
"""

from __future__ import annotations

import math
import sys

import torch

from .feed import quantize8

HUGE = 1e30  # stands for a missing or non-finite reading
# a frame's state tensors made before any flow: the ring's overlap strips
# and the fisheye strips, as the next frame's flow prior reads them
INPUT_KEYS = ("prev_overlap_l", "prev_overlap_r", "prev_fish")
RING_FLOWS = ("pair_flow_ltr", "pair_flow_rtl")
POLE_FLOWS = ("top_flow", "bottom_flow")


def state_gap(program: dict, reference: dict) -> dict:
    """The program's temporal state against the reference's: ``whole``,
    ||program - reference|| / ||reference|| over all its tensors together
    (the flows, in pixels, weigh most); ``worst``, the largest of that
    ratio per tensor, and its ``key``; ``each``, the ratio per tensor (a
    NaN on either side makes it ``HUGE``)."""
    if set(program) != set(reference):
        return dict(whole=HUGE, worst=HUGE, key="keys", each={})
    each, num2, den2 = {}, 0.0, 0.0
    for key, ref in reference.items():
        a, b = program[key].to(ref.device).double(), ref.double()
        if a.shape != b.shape:
            return dict(whole=HUGE, worst=HUGE, key=key, each={})
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
    between a delivered 8-bit frame and the reference's equirect, and the
    reference's NaN count (any makes the root mean square ``HUGE``)."""
    ref = quantize8(reference_eq).float()
    if tuple(delivered.shape) != tuple(ref.shape):
        return dict(rms=HUGE, max=HUGE, over2=1.0, nan=0)
    d = delivered.to(ref.device).float() - ref
    rms = float(torch.sqrt(torch.mean(d * d)))
    nan = int(torch.isnan(reference_eq).sum())
    return dict(rms=rms if math.isfinite(rms) and not nan else HUGE, max=float(d.abs().max()),
                over2=float((d.abs() > 2).float().mean()), nan=nan)


def flow_gaps(program, reference):
    """The length of program - reference for each vector of a flow (B, 2,
    h, w), in pixels of its grid, as (B, h * w) float64: a vector that
    either side gives as NaN is off by ``HUGE``. None where a side is
    missing or the shapes differ."""
    if program is None or reference is None or program.shape != reference.shape:
        return None
    d = torch.linalg.vector_norm(program.to(reference.device).double() - reference.double(),
                                 dim=1)
    return torch.nan_to_num(d, nan=HUGE, posinf=HUGE).flatten(1)


def flow_numbers(program: dict, reference: dict) -> dict:
    """The flow numbers of a frame without a prior from the program's and
    the reference's new states (the module's docstring)."""
    ring = [flow_gaps(program.get(n), reference.get(n)) for n in RING_FLOWS]
    pole = [flow_gaps(program.get(n), reference.get(n)) for n in POLE_FLOWS]
    if any(d is None for d in ring + pole):
        return dict.fromkeys(("still_ring_flow_p50_px", "still_ring_pair_p25_px",
                              "still_pole_flow_p25_px"), HUGE)
    return {"still_ring_flow_p50_px": max(float(d.flatten().median()) for d in ring),
            "still_ring_pair_p25_px": max(float(quartile(d, dim=1).max()) for d in ring),
            "still_pole_flow_p25_px": max(float(quartile(d.flatten(), dim=0)) for d in pole)}


def quartile(d: torch.Tensor, dim: int) -> torch.Tensor:
    """The first quartile of ``d`` along ``dim``: its n // 4-th smallest."""
    return d.kthvalue(max(1, d.shape[dim] // 4), dim=dim).values


def judge(cell, stream, checks, device, reference=None) -> tuple:
    """Render each checked frame with the reference (``reference``, a
    :class:`~.reference.system.Reference` of the cell's configuration,
    made here when None) and compare. Returns ({name: {"value", "limit"}}
    for the numbers with a limit, checked frames over a limit, {name:
    worst reading} of every number read)."""
    from .reference.system import Reference

    ref = reference or Reference(cell.config, device)
    worst: dict = {}
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
            del out
            st = state_gap(state_out, state)
            if state_in is None:
                flows = flow_numbers(state_out, state)
            del state
            nan = sum(int(torch.isnan(v).sum()) for v in state_out.values())
            each = " ".join(f"{n} {v:.3g}" for n, v in sorted(st["each"].items()))
            print(f"frame {k}: rms {gap['rms']:.6g} levels, max {gap['max']:.0f}, "
                  f"over 2 levels {gap['over2']:.3g}, reference NaN {gap['nan']}, "
                  f"state NaN {nan}; state whole {st['whole']:.6g}, worst {st['worst']:.6g} "
                  f"({st['key']}); {each}", file=sys.stderr, flush=True)
            if state_in is None:
                inputs = [v for n, v in st["each"].items() if n.endswith(INPUT_KEYS)]
                mine = {key: v.to(device) for key, v in state_out.items()}
                anchored, _ = ref.next(side, top, bottom, mine)
                del mine
                anch = frame_gap(delivered, anchored["equirect"])
                del anchored
                print(f"frame {k} anchored: rms {anch['rms']:.6g} levels, max "
                      f"{anch['max']:.0f}, over 2 levels {anch['over2']:.3g}",
                      file=sys.stderr, flush=True)
                now = {"start_inputs_rel": max(inputs) if inputs else HUGE, **flows,
                       "still_anchored_rms_levels": anch["rms"],
                       "still_rms_levels": gap["rms"]}
            else:
                now = {"chain_rms_levels": gap["rms"], "chain_state_rel": st["worst"]}
            if nan or gap["nan"]:
                now = dict.fromkeys(now, HUGE)
            if any(v > cell.limits[n] for n, v in now.items() if n in cell.limits):
                failed += 1
            for n, v in now.items():
                worst[n] = max(worst.get(n, 0.0), v)
            del state_in
    for n, v in worst.items():
        if n not in cell.limits:
            print(f"printed, not compared: {n} {v!r}", file=sys.stderr, flush=True)
    return {n: {"value": worst.get(n, HUGE), "limit": lim}
            for n, lim in cell.limits.items()}, failed, worst
