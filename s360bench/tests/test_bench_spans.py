"""A traced run at test scale on the CPU: every per-layer metric read from
the program's own spans (``s360bench/spans.py``) reads a number on the
host clock and None on the stream's (no CUDA events on the CPU); and a
program without the tracer reads None everywhere."""

import json
import sys

import pytest

from s360bench.run import load_benchmark, metric_reader, result_line, run_cell
from s360bench.tests.tiny import tiny_cell

SPAN_METRICS = [m for m in load_benchmark()["per_layer"]
                if "s360bench.spans" in open(f"s360bench/metrics/{m['name']}.py").read()]


@pytest.mark.parametrize("name", ["video_6k", "raw_6k"])
def test_traced_run_reads_the_spans(name):
    # flows at full scale: the pole flow has a coarser level at this size
    cell = tiny_cell(name, side_flow_scale=1.0, polar_flow_scale=1.0)
    r = run_cell(cell, 2**31 + 19, 1.0, True, "cpu")
    line = json.loads(json.dumps(result_line(cell, r, True, {"platform": "cpu"})))
    assert line["correct"] is True
    mine = [m for m in SPAN_METRICS if name in m["workloads"]]
    assert len(mine) == (18 if name == "raw_6k" else 16)
    for m in mine:
        value = metric_reader(m["name"])(r["data"])
        if m["name"].startswith("stream_ms."):
            assert value is None and m["name"] not in line["metrics"], m["name"]
        else:
            assert value > 0 and line["metrics"][m["name"]]["value"] == value, m["name"]
    frame_ms = metric_reader("host_ms.side_flow")(r["data"])
    flow_ms = sum(metric_reader(f"host_ms.flow_{lv}")(r["data"]) for lv in ("coarse", "finest"))
    assert 0 < flow_ms < frame_ms + metric_reader("host_ms.poles")(r["data"])


def test_spans_read_none_without_the_tracer(monkeypatch):
    import surround360_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "surround360_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(surround360_tpu_torch.utils, "tracing", raising=False)
    data = type("Data", (), {"frames": 3})()
    for m in SPAN_METRICS:
        assert metric_reader(m["name"])(data) is None, m["name"]
