"""The program's own spans in the traced window, per frame: what the
per-layer metrics of the frame's stages, the flow's pyramid levels, the
ISP and the set-up read.

The program's tracer (``surround360_tpu_torch/utils/tracing.py``) records
its spans while a profiler records, so its session is the traced window's
frames: the replay after the window and the reference's frames record
nothing. Its set-up spans (``setup.*``) are the whole process's. Host
milliseconds are how long the host took to issue a span's work; stream
milliseconds how long the stream took from the span's first operation to
its last, from CUDA events (none on the CPU). A program without the
tracer, or a run where the span is absent, reads None.
"""

from __future__ import annotations

CLOCKS = {"host": "host_ms", "stream": "stream_ms"}


def _tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from surround360_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def _per_frame(values, frames):
    if not values or not frames or any(v is None for v in values):
        return None
    return sum(values) / frames


def span_ms(data, name: str, clock: str) -> float | None:
    """Milliseconds a frame of the spans ``name`` on ``clock`` ("host" or
    "stream")."""
    tracing = _tracer()
    if tracing is None:
        return None
    total = tracing.totals().get(name)
    if total is None:
        return None
    return _per_frame([total[CLOCKS[clock]]], data.frames)


def flow_level_ms(data, finest: bool, clock: str) -> float | None:
    """Milliseconds a frame of the flow's pyramid levels, the finest
    (``finest``) or every coarser one, over every flow call of the
    frames."""
    tracing = _tracer()
    if tracing is None:
        return None
    spans = [s for s in tracing.session() if s.name == "flow.level"
             and s.end_ns is not None and s.attrs.get("finest") is finest]
    return _per_frame([getattr(s, CLOCKS[clock]) for s in spans], data.frames)


def setup_seconds(name: str) -> float | None:
    """Host seconds of the process's set-up spans ``name``, summed."""
    tracing = _tracer()
    if tracing is None:
        return None
    spans = [s for s in tracing.session() if s.name == name and s.end_ns is not None]
    if not spans:
        return None
    return sum(s.host_ms for s in spans) * 1e-3
