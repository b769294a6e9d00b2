"""``flow_graphed_pct``: the share of the traced frames' flow levels that
ran as CUDA graphs, read from the program's ``flow.level`` spans."""

import sys

import pytest
import torch

from s360bench.run import metric_reader

DATA = type("Data", (), {"frames": 3})()


def _levels(*graphed):
    from surround360_tpu_torch.utils import tracing

    with tracing.recording():
        for g in graphed:
            with tracing.span("flow.level", level=0, finest=True, h=4, w=4, graphed=g):
                pass


def test_share_of_graphed_levels():
    read = metric_reader("flow_graphed_pct")
    _levels(True, True, False, True)
    assert read(DATA) == pytest.approx(75.0)
    _levels(False, False)
    assert read(DATA) == 0.0


def test_cpu_flow_levels_read_zero():
    from surround360_tpu_torch.flow import compute_flow, make_flow_params
    from surround360_tpu_torch.utils import tracing

    g = torch.Generator().manual_seed(0)
    a, b = torch.rand((2, 4, 64, 96), generator=g), torch.rand((2, 4, 64, 96), generator=g)
    with tracing.recording():
        compute_flow(a, b, make_flow_params("pixflow_tpu"))
    assert metric_reader("flow_graphed_pct")(DATA) == 0.0


def test_none_without_the_attribute_or_the_tracer(monkeypatch):
    from surround360_tpu_torch.utils import tracing

    read = metric_reader("flow_graphed_pct")
    with tracing.recording():
        with tracing.span("flow.level", level=0, finest=True, h=4, w=4):
            pass
    assert read(DATA) is None  # a program whose levels say nothing of graphs
    with tracing.recording():
        with tracing.span("frame"):
            pass
    assert read(DATA) is None  # no flow level
    import surround360_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "surround360_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(surround360_tpu_torch.utils, "tracing", raising=False)
    assert read(DATA) is None
