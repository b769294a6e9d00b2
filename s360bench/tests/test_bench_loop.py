"""The loop of a run at test scale on the CPU, recorded call by call: a
mix without a prior renders every frame through ``first`` and checks
frames without a ``state_in``; a mix with the prior (the key absent)
chains every frame after frame 0 on the frame before it."""

import numpy as np
import pytest

from s360bench import check, run
from s360bench.run import EARLY_CHECK, HOST_FRAMES, TRACE_FRAMES, run_cell
from s360bench.tests.tiny import tiny_cell

SEED = 2**31 + 5


@pytest.fixture
def record(monkeypatch):
    """Every render of the run as (frame, state given, new state), and
    the frames handed to the check as (frame, state_in)."""
    calls, checked = [], []
    render, judge = run.Stream.render, check.judge

    def rendering(self, k, state):
        out, new = render(self, k, state)
        calls.append((k, state, new))
        return out, new

    def judging(cell, stream, checks, device, reference=None):
        checked.extend((k, state_in) for k, state_in, _, _ in checks)
        return judge(cell, stream, checks, device, reference)

    monkeypatch.setattr(run.Stream, "render", rendering)
    monkeypatch.setattr(check, "judge", judging)
    return calls, checked


def _early(seed):
    return 2 + int(np.random.default_rng([seed, 2]).integers(0, EARLY_CHECK))


def test_video_chains_every_frame_after_frame_0(record):
    calls, checked = record
    cell = tiny_cell("video_6k")
    assert "prior" not in cell.traffic
    r = run_cell(cell, SEED, 1.5, False, "cpu")
    frames = [k for k, _, _ in calls]
    assert frames == list(range(len(calls))) and r["attempted"] == len(calls) - 2
    assert calls[0][1] is None
    for (_, _, new), (_, given, _) in zip(calls, calls[1:]):
        assert given is new  # each frame from the new state of the frame before
    last = frames[-1]
    early = _early(SEED)
    want = [0] + ([early] if early < last else []) + [last]
    assert [k for k, _ in checked] == want
    assert checked[0][1] is None
    for k, state_in in checked[1:]:
        given = calls[k][1]
        assert set(state_in) == set(given)
        assert all((state_in[n] == given[n]).all() for n in given)


def test_stills_render_every_frame_without_a_prior(record):
    calls, checked = record
    cell = tiny_cell("stills_6k")
    assert cell.traffic["prior"] is False
    r = run_cell(cell, SEED, 1.0, False, "cpu")
    assert len(calls) >= 3 and all(given is None for _, given, _ in calls)
    assert [k for k, _, _ in calls] == list(range(len(calls)))
    assert len(checked) >= 2 and all(state_in is None for _, state_in in checked)
    assert set(r["numbers"]) == set(cell.limits)


def test_stills_traced_run_renders_every_frame_without_a_prior(record):
    calls, checked = record
    cell = tiny_cell("stills_6k")
    r = run_cell(cell, SEED, 1.0, True, "cpu")
    # warm-up, the host-timed frames, the traced frames and their replay
    assert len(calls) == 2 + HOST_FRAMES + 2 * TRACE_FRAMES
    assert all(given is None for _, given, _ in calls)
    assert [k for k, _ in checked] == [0, 1 + HOST_FRAMES + TRACE_FRAMES]
    assert all(state_in is None for _, state_in in checked)
    assert r["attempted"] == TRACE_FRAMES
