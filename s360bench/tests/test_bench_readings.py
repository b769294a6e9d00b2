"""``readings.py`` at test scale on the CPU: one line a seed, with every
number the check read, and a planted fault read as not correct."""

import json

from s360bench import readings, run
from s360bench.tests.tiny import tiny_cell


def test_one_line_a_seed(monkeypatch, capsys):
    monkeypatch.setattr(run, "resolve", lambda name: tiny_cell(name))
    assert readings.main(["--workload", "stills_6k", "--seeds", "5,6"]) == 0
    assert readings.main(["--workload", "stills_6k", "--seeds", "5",
                          "--fault", "first_answer_altered"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(d["seed"], d["system"]) for d in lines] == [
        (5, "program"), (6, "program"), (5, "first_answer_altered")]
    assert lines[2]["correct"] is False
    assert set(lines[0]["readings"]) == {"start_inputs_rel", "still_ring_flow_p50_px",
                                         "still_ring_pair_p25_px", "still_pole_flow_p25_px",
                                         "still_anchored_rms_levels", "still_rms_levels"}
