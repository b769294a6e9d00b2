"""A whole run at test scale on the CPU, skipping only the look for a GPU,
with the timed path broken underneath (``s360bench/faults.py``): each
fault a one-chip render cell can have makes ``correct`` false. (No cell
spans chips, so no exchange between chips can be left out.) The faults of
a frame without a prior are planted in ``first``: in ``stills_6k`` every
frame, in ``video_6k`` frame 0. At the smallest test scale every flow's
pyramid has one level, so the flow faults run at ``FLOWS``: twice the
panorama and the flows at full scale, where the ring's pyramids have two
levels and the poles' three, and the scene at ``FLOWS_SCENE_CM``, where
the flows are some pixels long, as they are on the card. There every pole
flow is zero (the 31 px alpha feather leaves no pole pixel the alpha a
flow update needs), so the faults of the pole flows alone run at
``POLES``: ``FLOWS`` with the feather cut as the panorama is (31 px of
6300 is 3 of 560)."""

import pytest
import torch

from s360bench.check import HUGE, frame_gap
from s360bench.faults import FIRST_FAULTS, FLOW_FAULTS, NEXT_FAULTS, Faulty
from s360bench.run import result_line, run_cell
from s360bench.tests.tiny import tiny_cell

FLOWS = dict(eqr_width=560, eqr_height=280, final_eqr_width=504, final_eqr_height=504,
             side_flow_scale=1.0, polar_flow_scale=1.0)
POLES = dict(FLOWS, std_alpha_feather_size=3)
FLOWS_SCENE_CM = 300.0
FLOW_NUMBERS = {"side_flow": {"still_ring_flow_p50_px", "still_ring_pair_p25_px"},
                "pole_flow": {"still_pole_flow_p25_px"}}
CASES = ([(name, fault) for name in ("video_6k", "raw_6k") for fault in NEXT_FAULTS]
         + [(name, fault) for name in ("stills_6k", "video_6k") for fault in FIRST_FAULTS])


def _run(name, fault="", scale=None):
    if scale is None and fault in FLOW_FAULTS:
        scale = POLES if FLOW_FAULTS[fault][1] == {"pole_flow"} else FLOWS
    cell = tiny_cell(name, **(scale or {}))
    if scale:
        cell.traffic["scene_distance_cm"] = FLOWS_SCENE_CM
    make = (lambda config, device: Faulty(config, device, fault)) if fault else None
    torch.manual_seed(0)
    r = run_cell(cell, 2**31 + 11, 0.5, False, "cpu", make_system=make)
    return r, result_line(cell, r, False, {"platform": "cpu"})


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    r, line = _run(name, fault)
    assert line["correct"] is False and line["failed"] >= 1
    if fault in FLOW_FAULTS:
        # caught by a number of the flows it breaks, not by the inputs
        sites = FLOW_FAULTS[fault][1] or FLOW_NUMBERS.keys()
        over = {n for n, v in line["checks"].items() if v["value"] > v["limit"]}
        assert over & set().union(*(FLOW_NUMBERS[s] for s in sites))


def test_sound_run_is_correct():
    assert _run("raw_6k")[1]["correct"] is True


@pytest.mark.parametrize("name", ["stills_6k", "video_6k"])
def test_sound_run_without_a_prior_is_correct(name):
    """At the flow faults' scale. (A sound run's
    ``still_anchored_rms_levels`` reads 0.047-0.068 by seed at the
    smallest scale and 0.047 at this one, against the card's 0.021-0.027:
    the state's ring flows are 10-60 px across here, and taking them
    through the reference's resampling moves the frame more.)"""
    assert _run(name, scale=FLOWS)[1]["correct"] is True


@pytest.mark.parametrize("name", ["stills_6k", "video_6k"])
def test_sound_flows_are_within_their_limits_at_the_poles_scale(name):
    """At ``POLES``, where the pole faults are read, a sound run's flow
    numbers are within their limits, so that those faults are caught by
    what they break. (Its ``still_anchored_rms_levels`` reads 0.07-0.11
    there by feather, against the card's 0.02-0.03: with the pole flows
    some pixels long on a 560 px panorama, the reference's re-solve from
    them moves the frame more.)"""
    line = _run(name, scale=POLES)[1]
    flows = set().union(*FLOW_NUMBERS.values())
    assert flows <= set(line["checks"])
    for n in flows:
        assert line["checks"][n]["value"] <= line["checks"][n]["limit"], n


def test_a_nan_in_the_reference_frame_fails():
    delivered = torch.zeros((3, 4, 4), dtype=torch.uint8)
    reference = torch.zeros((3, 4, 4))
    assert frame_gap(delivered, reference)["rms"] == 0.0
    reference[1, 2, 3] = float("nan")
    assert frame_gap(delivered, reference)["rms"] == HUGE
