"""The traced run's readings: a ``torch.profiler`` trace of the traced
frames, reduced to what the per-layer metrics read.

The benchmark marks its own calls into the program with
``record_function`` spans (``SPANS``); the window is the span
``s360bench.window``. Device activity is every kernel, copy and fill of
the trace.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

WINDOW = "s360bench.window"
SPANS = ("s360bench.feed", "s360bench.isp", "s360bench.render", "s360bench.deliver",
         "s360bench.wait")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceData:
    """What one traced run read. Times in seconds."""

    frames: int
    window_s: float
    busy_s: float
    kernels: list  # (name, seconds) of every kernel in the window
    device_ops: list  # (name, seconds): device time by operation name, largest first
    idle_gaps: list  # (host span open when the device went idle, seconds), longest first
    isp_kernel_s: float = 0.0  # kernels launched inside ``s360bench.isp`` spans
    host_enqueue_s: list = field(default_factory=list)  # host seconds a render call took
    call_bytes: dict = field(default_factory=dict)  # kernel -> least bytes of its calls
    kernel_names: dict = field(default_factory=dict)  # kernel -> its name in the trace


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A device operation's name, cut to 160 characters."""
    return name[:160]


def read_chrome_trace(path: str, frames: int) -> TraceData:
    """Reduce an exported chrome trace (``export_chrome_trace``)."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)

    by_name: dict = {}
    for e in dev:
        n = short_name(e["name"])
        by_name[n] = by_name.get(n, 0.0) + float(e["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in xs if e.get("cat") == "user_annotation" and e["name"] in SPANS)

    def open_span(t):
        best = None
        for a, b, n in spans:
            if a > t:
                break
            if b >= t and (best is None or a >= best[0]):
                best = (a, n)
        return best[1] if best else "other"

    gaps = []
    edges = [w0] + [v for ab in busy for v in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((open_span(a), (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])

    isp_spans = [(a, b) for a, b, n in spans if n == "s360bench.isp"]
    isp_corr = set()
    if isp_spans:
        for e in xs:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                t = float(e["ts"])
                if any(a <= t <= b for a, b in isp_spans):
                    isp_corr.add(e["args"]["correlation"])
    isp_s = sum(float(e["dur"]) * 1e-6 for e in dev if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in isp_corr)

    kernels = [(e["name"], float(e["dur"]) * 1e-6) for e in dev if e.get("cat") == "kernel"]
    return TraceData(frames=frames, window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                     kernels=kernels, device_ops=device_ops, idle_gaps=gaps,
                     isp_kernel_s=isp_s)


def kernel_seconds(data: TraceData, kernel: str) -> float:
    """Device seconds of the program's kernel ``kernel`` in the window."""
    trace_name = data.kernel_names.get(kernel, kernel)
    return sum(s for n, s in data.kernels if trace_name in n)
