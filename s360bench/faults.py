"""Faults planted in the program, each a way the timed path could break
that the check has to catch (``tests/test_bench_faults.py``; on the card,
``readings.py --fault``).

Through ``next`` (a chained frame): ``state_unchanged``, the step returns
the state it was given; ``half_the_cameras``, the last seven side
cameras left out; ``answer_altered``, an eighth of the delivered rows
3 levels off. Through ``first`` (a frame without a prior):
``first_half_the_cameras`` and ``first_answer_altered``, the same;
``no_prior_flows_zeroed``, every flow of the frame zero;
``no_prior_flow_unrefined``, every flow stopped before its finest
pyramid level (the next coarser level's flow, upsampled, taken as it);
``no_prior_pole_flows_zeroed`` and ``no_prior_pole_flow_unrefined``, the
same of the pole flows alone; ``no_prior_one_pair_zeroed``, the flows of
the ring's first pair zero, both directions; ``no_prior_state_nan``, a NaN
in the new state's top side strip, where an overflowing view blend
leaves one.
"""

from __future__ import annotations

import contextlib

import torch

from .program import Program

NEXT_FAULTS = ("state_unchanged", "half_the_cameras", "answer_altered")
FIRST_FAULTS = ("first_half_the_cameras", "first_answer_altered", "no_prior_flows_zeroed",
                "no_prior_flow_unrefined", "no_prior_pole_flows_zeroed",
                "no_prior_pole_flow_unrefined", "no_prior_one_pair_zeroed", "no_prior_state_nan")
# a flow fault -> (what it does, the flow sites it breaks; None: every site)
FLOW_FAULTS = {
    "no_prior_flows_zeroed": ("zeroed", None),
    "no_prior_flow_unrefined": ("unrefined", None),
    "no_prior_pole_flows_zeroed": ("zeroed", {"pole_flow"}),
    "no_prior_pole_flow_unrefined": ("unrefined", {"pole_flow"}),
    "no_prior_one_pair_zeroed": ("pair_zeroed", {"side_flow"}),
}


def _half_the_cameras(side):
    side = side.clone()
    side[side.shape[0] // 2:] = 0.0
    return side


def _answer_altered(out):
    eq = out["equirect"].clone()
    eq[:, : eq.shape[1] // 8] += 3.0 / 255.0
    return dict(out, equirect=eq)


@contextlib.contextmanager
def _flow_fault(fault: str):
    """The port's flow broken while open, at the sites of ``FLOW_FAULTS``:
    ``compute_flow``'s flow zero (or its first batch member's, one ring
    pair), as the ring (``views/novel_view.py``) and the poles
    (``render/panorama.py``) call it, or every pyramid stopped before its
    finest level (``flow/pixflow.py::_level_step``)."""
    from surround360_tpu_torch.flow import pixflow
    from surround360_tpu_torch.render import panorama
    from surround360_tpu_torch.views import novel_view

    how, sites = FLOW_FAULTS.get(fault, (None, None))
    if how is None:
        yield
        return

    def broken(site):
        return sites is None or site in sites

    level_step, compute_flow = pixflow._level_step, pixflow.compute_flow

    def unrefined(src, flow, level, sizes, params, use_temporal, site):
        if level == 0 and broken(site):  # a one-level pyramid stops at zero
            return flow if flow is not None else src[0].new_zeros((src[0].shape[0], 2,
                                                                    *sizes[0]))
        return level_step(src, flow, level, sizes, params, use_temporal, site)

    def zeroed(*args, site="", **kw):
        flow = compute_flow(*args, site=site, **kw)
        if not broken(site):
            return flow
        if how == "zeroed":
            return torch.zeros_like(flow)
        flow = flow.clone()
        flow[0] = 0.0
        return flow

    patches = ([(pixflow, "_level_step", unrefined)] if how == "unrefined" else
               [(panorama, "compute_flow", zeroed), (novel_view, "compute_flow", zeroed)])
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class Faulty(Program):
    """The program with ``fault`` planted (one of NEXT_FAULTS or
    FIRST_FAULTS)."""

    def __init__(self, config: dict, device, fault: str):
        super().__init__(config, device)
        if fault not in NEXT_FAULTS + FIRST_FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault

    def first(self, side, top, bottom):
        if self.fault == "first_half_the_cameras":
            side = _half_the_cameras(side)
        with _flow_fault(self.fault):
            out, new = super().first(side, top, bottom)
        if self.fault == "first_answer_altered":
            out = _answer_altered(out)
        if self.fault == "no_prior_state_nan":
            side = new["top_prev_side"].clone()
            side[0, 0, 0, 0] = float("nan")
            new = dict(new, top_prev_side=side)
        return out, new

    def next(self, side, top, bottom, state):
        if self.fault == "half_the_cameras":
            side = _half_the_cameras(side)
        out, new = super().next(side, top, bottom, state)
        if self.fault == "state_unchanged":
            return out, state
        if self.fault == "answer_altered":
            out = _answer_altered(out)
        return out, new
