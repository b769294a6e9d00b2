"""The program's tracer: named spans where the work happens, read as
host and stream time by name.

    with span("side_flow"):               # where the work is issued
        ...
        count("launches.fused_window_sample")

    with recording():                     # or under torch.profiler
        render_frame(...)
    torch.cuda.synchronize()
    totals()["side_flow"]["host_ms"]

A span records its name, an id, its parent's id (the innermost span open
on the same thread) and its host start and end on ``time.perf_counter_ns``.
Where CUDA is initialised it also records a pair of timing events on the
current stream, so ``stream_ms`` is the time the stream took from the
span's first operation to its last, waiting for the host included. While
a torch profiler is recording, it also enters ``record_function(name)``,
so the span lies in the device trace beside the kernels it launched.

Tracing is on inside :func:`recording` and whenever a torch profiler is
recording. A session is what was recorded since tracing last went from
off to on; a new session drops the last one. Off, a span costs a flag
check and records nothing. Spans named ``setup.*`` run once per process
(the render context, the static remap plans) and are recorded always, on
the host clock only, and kept for the process.

The tracer never synchronises, calls ``.item()`` or copies to the host:
a span's events are resolved only when the record is read
(:attr:`Span.stream_ms`, :func:`totals`), after the caller's own
synchronise. :class:`StageTimer`, the CLI loops' stage list, opens its
stages as spans ``cli.<stage>`` on the same clock.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "recording", "session", "totals", "now_ns", "Span",
           "StageTimer"]

SETUP_PREFIX = "setup."
_SETUP_KEEP = 4096  # set-up spans kept for the process

now_ns = time.perf_counter_ns


class _State(threading.local):
    def __init__(self):
        self.stack: list = []  # open recorded spans of this thread, innermost last


_LOCAL = _State()
_IDS = itertools.count(1)
_LOCK = threading.Lock()  # guards the opening of a session
_recording = 0  # depth of open recording() blocks
_live = False  # whether tracing was on at the last span: a session is open
_session: list = []
_setup: collections.deque = collections.deque(maxlen=_SETUP_KEEP)


def _on() -> bool:
    return bool(_recording) or _profiler._is_profiler_enabled


def _open_session() -> None:
    global _live, _session
    if not _live:
        with _LOCK:
            if not _live:
                _live, _session = True, []


class Span:
    """One recorded span. ``start_ns`` / ``end_ns`` on the host clock
    (``end_ns`` None while open); ``counts`` holds what :func:`count`
    added while it was the innermost span."""

    __slots__ = ("name", "id", "parent", "attrs", "counts", "start_ns", "end_ns",
                 "_events", "_stream_ms", "_annotation")

    def __init__(self, name: str, attrs: dict, timed: bool):
        self.name, self.attrs = name, attrs
        self.id, self.parent = 0, None
        self.counts: dict = {}
        self.start_ns = self.end_ns = None
        self._events = () if timed else None
        self._stream_ms = None
        self._annotation = None

    def __enter__(self):
        stack = _LOCAL.stack
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        (_setup if self._events is None else _session).append(self)
        if _profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        if self._events is not None and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start,)
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = now_ns()
        if self._events:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _LOCAL.stack.pop()
        return False

    @property
    def host_ms(self) -> float | None:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def stream_ms(self) -> float | None:
        """The stream's time from the span's first operation to its last,
        resolved from its events at the first read (None without events).
        Read after the device has finished the span's work."""
        if self._stream_ms is None and self._events and len(self._events) == 2:
            start, end = self._events
            end.synchronize()
            self._stream_ms = float(start.elapsed_time(end))
            self._events = ()
        return self._stream_ms

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.id}, parent={self.parent}, {self.attrs})"


class _Off:
    """The span of tracing switched off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, /, **attrs):
    """A context manager recording ``name`` while tracing is on (a no-op
    otherwise); ``attrs`` are kept with the span."""
    global _live
    if _recording or _profiler._is_profiler_enabled:
        _open_session()
        return Span(name, attrs, timed=not name.startswith(SETUP_PREFIX))
    _live = False
    if name.startswith(SETUP_PREFIX):
        return Span(name, attrs, timed=False)
    return _OFF


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the innermost span open on this
    thread (nothing while tracing is off)."""
    if _recording or _profiler._is_profiler_enabled:
        stack = _LOCAL.stack
        if stack:
            counts = stack[-1].counts
            counts[key] = counts.get(key, 0) + n


@contextmanager
def recording():
    """Tracing on while open; opens a new session when it was off."""
    global _recording, _live
    if not _on():
        _live = False
    _open_session()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1
        if not _on():
            _live = False


def session() -> list:
    """The spans of the process's set-up (``setup.*``), then those of the
    current or last session, each list in order of start."""
    return list(_setup) + list(_session)


def totals(spans: list | None = None) -> dict:
    """Per span name (of ``spans``, :func:`session` by default):
    ``n`` spans, summed ``host_ms`` and ``stream_ms`` (None where a span
    has no events), ``self_host_ms`` / ``self_stream_ms`` (less what its
    child spans cover) and ``counts`` (the counters of its spans and
    their descendants). Spans still open are left out."""
    spans = [s for s in (session() if spans is None else spans) if s.end_ns is not None]
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)

    def inclusive_counts(s, out):
        for k, v in s.counts.items():
            out[k] = out.get(k, 0) + v
        for c in children.get(s.id, ()):
            inclusive_counts(c, out)
        return out

    def add(a, b):
        return None if a is None or b is None else a + b

    out: dict = {}
    for s in spans:
        kids = children.get(s.id, ())
        host, stream = s.host_ms, s.stream_ms
        self_host, self_stream = host, stream
        for c in kids:
            self_host -= c.host_ms
            self_stream = None if self_stream is None or c.stream_ms is None \
                else self_stream - c.stream_ms
        t = out.get(s.name)
        if t is None:
            t = out[s.name] = dict(n=0, host_ms=0.0, stream_ms=0.0, self_host_ms=0.0,
                                   self_stream_ms=0.0, counts={})
        t["n"] += 1
        t["host_ms"] += host
        t["stream_ms"] = add(t["stream_ms"], stream)
        t["self_host_ms"] += self_host
        t["self_stream_ms"] = add(t["self_stream_ms"], self_stream)
        inclusive_counts(s, t["counts"])
    return out


class StageTimer:
    """The CLI loops' host stages (decode, render, encode, ...): each
    entry is a span ``cli.<stage>`` and a (stage, seconds) entry in
    :attr:`stages`, on the tracer's clock; prints the runtime-breakdown
    table like TestRenderStereoPanorama.cpp:963-971."""

    def __init__(self):
        self.stages: list[tuple[str, float]] = []
        self._t0 = now_ns()

    @contextmanager
    def stage(self, name: str):
        with span("cli." + name):
            t = now_ns()
            yield
            self.stages.append((name, (now_ns() - t) * 1e-9))

    def totals(self) -> dict[str, tuple[int, float]]:
        """name -> (entries, summed seconds), in order of first entry."""
        out: dict[str, tuple[int, float]] = {}
        for name, dt in list(self.stages):
            n, secs = out.get(name, (0, 0.0))
            out[name] = (n + 1, secs + dt)
        return out

    def report(self) -> str:
        lines = ["--- Runtime breakdown (sec) ---"]
        lines.append(f"Total:\t{(now_ns() - self._t0) * 1e-9:.3f}")
        for name, dt in self.stages:
            lines.append(f"{name}:\t{dt:.3f}")
        return "\n".join(lines)
