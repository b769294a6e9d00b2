"""The port's tracer (``utils/tracing.py``): what it records off and on,
the span tree of a frame, a flow call and an ISP call, the set-up spans,
the spans in a profiler trace, per-thread parents, the launch counter and
when the stream's events are resolved."""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from surround360_tpu_torch.flow import compute_flow, make_flow_params
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.isp import pipeline as isp_pipeline
from surround360_tpu_torch.isp.pipeline import IspConfig, isp_process
from surround360_tpu_torch.ops import fused_window as fw
from surround360_tpu_torch.render.panorama import (
    RenderConfig,
    build_render_context,
    render_frame,
)
from surround360_tpu_torch.render.profiling import STAGES
from surround360_tpu_torch.utils import tracing

KW = dict(eqr_width=140, eqr_height=70, enable_top=True, enable_bottom=True,
          side_flow_alg="pixflow_tpu", polar_flow_alg="pixflow_tpu",
          side_alpha_feather_size=8, std_alpha_feather_size=9, sharpening=0.25)


def _recorded():
    return [s for s in tracing.session() if not s.name.startswith("setup.")]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


@pytest.fixture(scope="module")
def scene():
    rig = make_ring_rig().rescaled(0.03125)  # 64 px cameras
    ctx = build_render_context(rig, RenderConfig(**KW))
    g = torch.Generator().manual_seed(0)
    side = torch.rand((14, 4, 64, 64), generator=g)
    top, bottom = torch.rand((4, 64, 64), generator=g), torch.rand((4, 64, 64), generator=g)
    return ctx, side, top, bottom


def test_off_records_nothing_and_enters_no_record_function(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    ctx, side, top, bottom = scene
    before = _recorded()
    with tracing.span("outer", k=1) as s:
        tracing.count("launches.fused_window_sample")
        assert s is None
    render_frame(ctx, side, top, bottom)
    assert _recorded() == before


def test_recording_gives_the_frame_tree(scene):
    ctx, side, top, bottom = scene
    with tracing.recording():
        _, state = render_frame(ctx, side, top, bottom)
    spans = _recorded()
    (frame,) = [s for s in spans if s.name == "frame"]
    assert frame.parent is None and frame.attrs == {"temporal": False}
    stages = [s.name for s in _children(spans, frame)]
    assert [n for i, n in enumerate(stages) if n not in stages[:i]] == list(STAGES)
    (poles,) = [s for s in spans if s.name == "poles"]
    assert sorted(s.attrs["pole"] for s in _children(spans, poles)
                  if s.name == "poles.strip") == ["bottom", "top"]
    flows = [s for s in spans if s.name == "flow"]
    assert {spans[[x.id for x in spans].index(f.parent)].name for f in flows} == \
        {"side_flow", "poles"}
    for f in flows:
        levels = _children(spans, f)
        assert levels and all(lv.name == "flow.level" for lv in levels)
        assert [lv.attrs["finest"] for lv in levels].count(True) == 1
        assert levels[-1].attrs["finest"] and levels[-1].attrs["level"] == 0
    assert all(s.host_ms >= 0 and s.stream_ms is None for s in spans)
    t = tracing.totals()
    assert sum(t[n]["host_ms"] for n in STAGES) <= t["frame"]["host_ms"]
    assert t["frame"]["self_host_ms"] == pytest.approx(
        t["frame"]["host_ms"] - sum(t[n]["host_ms"] for n in STAGES))
    with tracing.recording():  # a new session drops the last one
        render_frame(ctx, side, top, bottom, state=state, use_temporal=True)
    assert [s.attrs for s in _recorded() if s.name == "frame"] == [{"temporal": True}]


def test_flow_levels_and_isp_steps():
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand((2, 4, 96, 128), generator=g), torch.rand((2, 4, 96, 128), generator=g)
    raw = torch.rand((32, 48), generator=g)
    cfg = IspConfig(bayer_pattern="GBRG", sharpening=(0.3, 0.3, 0.3))
    isp_pipeline._TABLES.clear()
    with tracing.recording():
        compute_flow(a, b, make_flow_params("pixflow_tpu"), site="test")
        isp_process(raw, cfg)
        isp_process(raw, cfg)
    spans = _recorded()
    (flow,) = [s for s in spans if s.name == "flow"]
    assert flow.attrs == {"site": "test", "batch": 2}
    levels = [(s.attrs["level"], s.attrs["finest"], s.attrs["h"], s.attrs["w"])
              for s in _children(spans, flow)]
    assert levels == [(1, False, 24, 32), (0, True, 48, 64)]
    isps = [s for s in spans if s.name == "isp"]
    for isp in isps:
        assert [s.name for s in _children(spans, isp)] == [
            "isp.tables", "isp.correct", "isp.stuck", "isp.demosaic", "isp.color",
            "isp.sharpen"]
    # the first call makes the tables, the second finds them
    assert [_children(spans, isp)[0].counts for isp in isps] == [
        {"isp.tables.miss": 1}, {"isp.tables.hit": 1}]


def test_setup_spans_are_recorded_with_tracing_off():
    rig = make_ring_rig().rescaled(0.03125)
    ctx = build_render_context(rig, RenderConfig(**dict(KW, enable_top=False)))
    ctx.static_plan("side", (64, 64), torch.device("cpu"))
    ctx.static_plan("side", (64, 64), torch.device("cpu"))  # a hit: no span
    context, plan = [s for s in tracing.session() if s.name.startswith("setup.")][-2:]
    assert (context.name, plan.name, plan.attrs) == ("setup.context", "setup.plan",
                                                     {"name": "side"})
    assert context.host_ms > 0 and plan.host_ms > 0 and plan.stream_ms is None
    assert tracing.totals([context])["setup.context"]["host_ms"] == context.host_ms


def test_profiler_records_spans_as_user_annotations(tmp_path):
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner", level=3):
                torch.ones(8).sum()
    spans = _recorded()
    assert [s.name for s in spans] == ["outer", "inner"]
    assert spans[1].parent == spans[0].id and spans[1].attrs == {"level": 3}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names
    with tracing.span("after"):  # the profiler stopped: tracing is off
        pass
    assert [s.name for s in _recorded()] == ["outer", "inner"]


def test_threads_keep_separate_parent_stacks():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(tag + ".outer"):
            barrier.wait()
            with tracing.span(tag + ".inner"):
                barrier.wait()

    with tracing.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in _recorded()}
    for tag in ("a", "b"):
        assert by_name[tag + ".outer"].parent is None
        assert by_name[tag + ".inner"].parent == by_name[tag + ".outer"].id


def test_launches_count_in_the_innermost_span(scene, monkeypatch):
    """The wrappers' counter adds ``launches.<kernel>`` to the innermost
    span (here through the stub that counts, since the CPU twins launch
    nothing), and LAUNCHES as before."""
    ctx, side, top, bottom = scene
    monkeypatch.setattr(fw, "LAUNCHES", collections.Counter())
    real = fw.fused_window_sample

    def counting(*a, site="", **k):
        fw._count(fw.K1, site)
        return real(*a, site=site, **k)

    monkeypatch.setattr("surround360_tpu_torch.ops.remap.fused_window_sample", counting)
    with tracing.recording():
        with tracing.span("outer"):
            render_frame(ctx, side, top, bottom)
    key = "launches." + fw.K1
    spans = _recorded()
    counted = {s.name: s.counts for s in spans if s.counts and s.name != "flow.level"}
    assert counted == {"projection": {key: 1}, "poles.strip": {key: 1}}
    assert [s.counts for s in spans if s.name == "poles.strip"] == [{key: 1}] * 2
    # each flow level counts how it ran: eagerly, on the CPU
    levels = [s for s in spans if s.name == "flow.level"]
    assert levels and all(s.counts == {"flow.graph.eager": 1} for s in levels)
    both = {key: 3, "flow.graph.eager": len(levels)}
    t = tracing.totals()
    assert t["outer"]["counts"] == t["frame"]["counts"] == both
    assert fw.LAUNCHES[(fw.K1, "side_projection")] == 1
    assert fw.LAUNCHES[(fw.K1, "fisheye_strip")] == 2
    fw._count(fw.K1, "off")  # tracing off: LAUNCHES only
    assert fw.LAUNCHES[(fw.K1, "off")] == 1
    assert tracing.totals()["frame"]["counts"] == both


def test_events_are_resolved_only_when_the_record_is_read(monkeypatch):
    calls = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self, stream=None):
            self.t = float(len(calls))
            calls.append("record")

        def synchronize(self):
            calls.append("synchronize")

        def elapsed_time(self, end):
            calls.append("elapsed_time")
            return (end.t - self.t) * 10.0

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with tracing.recording():
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    assert calls == ["record"] * 4
    spans = _recorded()
    assert calls == ["record"] * 4
    t = tracing.totals()
    assert t["outer"]["stream_ms"] == 30.0 and t["inner"]["stream_ms"] == 10.0
    assert t["outer"]["self_stream_ms"] == 20.0
    assert calls.count("elapsed_time") == 2
    assert [s.stream_ms for s in spans] == [30.0, 10.0] and calls.count("elapsed_time") == 2


def test_stage_timer_keeps_its_table():
    timer = tracing.StageTimer()
    with tracing.recording():
        with timer.stage("render"):
            np.zeros(4).sum()
        with timer.stage("render"):
            pass
    assert [n for n, _ in timer.stages] == ["render", "render"]
    assert timer.totals()["render"][0] == 2
    assert [s.name for s in _recorded()] == ["cli.render", "cli.render"]
    assert "render:" in timer.report() and timer.report().startswith("--- Runtime")


@pytest.mark.gpu
def test_events_time_the_stream_on_the_card():
    """On the card a span's stream time covers the work it enqueued, and
    a parent's covers its child's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.rand((2048, 2048), device="cuda")
    torch.cuda.synchronize()
    with tracing.recording():
        with tracing.span("outer"):
            for _ in range(20):
                a = torch.tanh(a @ a)
            with tracing.span("inner"):
                a.sum()
    torch.cuda.synchronize()
    t = tracing.totals()
    assert t["outer"]["stream_ms"] > t["inner"]["stream_ms"] > 0
    assert t["outer"]["stream_ms"] > 1.0 and t["outer"]["self_stream_ms"] > 0
