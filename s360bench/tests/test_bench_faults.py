"""A whole run at test scale on the CPU, skipping only the look for a GPU,
with the timed path broken underneath: each fault a one-chip render cell
can have makes ``correct`` false. (No cell spans chips, so no exchange
between chips can be left out.)"""

import pytest
import torch

from s360bench.program import Program
from s360bench.run import result_line, run_cell
from s360bench.tests.tiny import tiny_cell


class Faulty(Program):
    fault = ""

    def next(self, side, top, bottom, state):
        if self.fault == "half_the_cameras":
            # half of the batch left out: the last seven side cameras unseen
            side = side.clone()
            side[side.shape[0] // 2:] = 0.0
        out, new = super().next(side, top, bottom, state)
        if self.fault == "state_unchanged":
            return out, state
        if self.fault == "answer_altered":
            eq = out["equirect"].clone()
            eq[:, : eq.shape[1] // 8] += 3.0 / 255.0
            out = dict(out, equirect=eq)
        return out, new


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_cameras", "answer_altered"])
@pytest.mark.parametrize("name", ["video_6k", "raw_6k"])
def test_fault_is_not_correct(fault, name):
    cell = tiny_cell(name)

    def make(config, device):
        system = Faulty(config, device)
        system.fault = fault
        return system

    torch.manual_seed(0)
    r = run_cell(cell, 2**31 + 11, 0.5, False, "cpu", make_system=make)
    line = result_line(cell, r, False, {"platform": "cpu"})
    assert line["correct"] is False and line["failed"] >= 1


def test_sound_run_is_correct():
    cell = tiny_cell("raw_6k")
    r = run_cell(cell, 2**31 + 11, 0.5, False, "cpu")
    assert result_line(cell, r, False, {"platform": "cpu"})["correct"] is True
