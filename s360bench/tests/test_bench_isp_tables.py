"""``isp_tables_hit_pct``: the share of the traced frames' ISP calls that
found their tables on the device, read from the program's ``isp.tables``
spans and their counters."""

import sys

import pytest
import torch

from s360bench.run import metric_reader

DATA = type("Data", (), {"frames": 3})()


def _tables(*counters):
    from surround360_tpu_torch.utils import tracing

    with tracing.recording():
        for key in counters:
            with tracing.span("isp"):
                with tracing.span("isp.tables"):
                    if key is not None:
                        tracing.count(key)


def test_share_of_hits():
    read = metric_reader("isp_tables_hit_pct")
    _tables(*["isp.tables.hit"] * 17)
    assert read(DATA) == 100.0
    _tables("isp.tables.miss", "isp.tables.hit", "isp.tables.hit", "isp.tables.hit")
    assert read(DATA) == pytest.approx(75.0)
    _tables("isp.tables.miss", "isp.tables.miss")
    assert read(DATA) == 0.0


def test_cpu_isp_calls_read_miss_then_hit():
    from surround360_tpu_torch.isp import pipeline
    from surround360_tpu_torch.utils import tracing

    raw = torch.rand((24, 32), generator=torch.Generator().manual_seed(0))
    cfg = pipeline.IspConfig(bits_per_pixel=12, black_level=(64.0, 64.0, 64.0))
    pipeline._TABLES.clear()
    with tracing.recording():
        for _ in range(4):
            pipeline.isp_process(raw, cfg)
    assert metric_reader("isp_tables_hit_pct")(DATA) == pytest.approx(75.0)


def test_none_without_the_counters_or_the_tracer(monkeypatch):
    read = metric_reader("isp_tables_hit_pct")
    _tables(None, None)
    assert read(DATA) is None  # a program whose tables count nothing
    _tables()
    assert read(DATA) is None  # no ISP call
    import surround360_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "surround360_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(surround360_tpu_torch.utils, "tracing", raising=False)
    assert read(DATA) is None
