"""Per-frame stage table of the frame pipeline, read from the frame's spans.

Port of ``surround360_tpu/render/profiling.py``. The reference logs a
per-frame stage table (projection / side flow / novel view / pole flow /
sharpen, TestRenderStereoPanorama.cpp:963-971). Here the frames are
rendered in the chain as usual with tracing on (``utils/tracing.py``'s
``recording()``), and each frame's table is read from the spans that
``render/panorama.py`` and ``flow/pixflow.py`` open where the work
happens: per stage of :data:`STAGES`, the host milliseconds it took to
issue, the milliseconds its stream took from its first operation to its
last (on a GPU; waiting for the host included), its share of the frame's
host time and the launches of the fused window kernels inside it; then
the flow by call site and pyramid level. Wired into ``cli/render_video``
via ``--profile_stages`` and ``benchmarks/profile_stages.py``.

The reference's XLA cost analysis, trace and compile seconds, dispatch
floor and roofline columns have no counterpart in an eager PyTorch
renderer and are not reproduced.
"""

from __future__ import annotations

__all__ = ["STAGES", "stage_breakdown", "format_breakdown"]

# the frame's stage spans, in the order they run
STAGES = ("projection", "side_flow", "novel_view", "poles", "output")
_LAUNCHES = "launches."


def _add(a, b):
    return None if a is None or b is None else a + b


def stage_breakdown(spans, frame: int | None = None) -> dict:
    """The stage table of the ``frame`` span with that id among ``spans``
    (``tracing.session()``), or the mean over every ``frame`` span when
    None. Read it once the device has finished those frames.

    Returns {row: dict(host_ms, stream_ms, share, launches)} with the rows
    ``frame``, the stages of :data:`STAGES` that ran (a stage's spans
    summed) and ``flow.<site>.L<level>`` (level 0 the finest; every flow
    call of the frame at that site). ``stream_ms`` is None without CUDA
    events, ``share`` is of the frame's host time and ``launches`` maps
    each fused window kernel to its launches."""
    spans = [s for s in spans if s.end_ns is not None]
    frames = [s for s in spans if s.name == "frame" and frame in (None, s.id)]
    if not frames:
        raise ValueError("no frame span" + ("" if frame is None else f" with id {frame}"))
    by_id = {s.id: s for s in spans}
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)

    def subtree(s):
        yield s
        for c in children.get(s.id, ()):
            yield from subtree(c)

    rows: dict = {}

    def add(name, s):
        row = rows.setdefault(name, dict(host_ms=0.0, stream_ms=0.0, launches={}))
        row["host_ms"] += s.host_ms
        row["stream_ms"] = _add(row["stream_ms"], s.stream_ms)
        for d in subtree(s):
            for key, n in d.counts.items():
                if key.startswith(_LAUNCHES):
                    kernel = key[len(_LAUNCHES):]
                    row["launches"][kernel] = row["launches"].get(kernel, 0) + n

    for f in frames:
        for s in subtree(f):
            if s.name == "frame" or s.name in STAGES:
                add(s.name, s)
            elif s.name == "flow.level":
                site = by_id[s.parent].attrs.get("site") if s.parent in by_id else None
                add(f"flow.{site or 'flow'}.L{s.attrs['level']}", s)
    flows = sorted((r for r in rows if r.startswith("flow.")),
                   key=lambda r: (r.rsplit(".L", 1)[0], -int(r.rsplit(".L", 1)[1])))
    n = len(frames)
    frame_ms = rows["frame"]["host_ms"]
    return {
        name: dict(host_ms=rows[name]["host_ms"] / n,
                   stream_ms=None if rows[name]["stream_ms"] is None
                   else rows[name]["stream_ms"] / n,
                   share=rows[name]["host_ms"] / frame_ms,
                   launches={k: v / n for k, v in rows[name]["launches"].items()})
        for name in ["frame", *[s for s in STAGES if s in rows], *flows]
    }


def format_breakdown(rows: dict, title: str = "") -> str:
    """The stage table: host and stream milliseconds, the share of the
    frame's host time and the kernels' launches, one line per row."""
    lines = [f"stage breakdown{title} (in the chain; host ms to issue, stream ms "
             "on the device, share of the frame's host time, kernel launches):"]
    for name, row in rows.items():
        stream = row["stream_ms"]
        line = (f"  {name:26s} {row['host_ms']:10.2f} ms host "
                + (f"{stream:10.2f}" if stream is not None else f"{'n/a':>10s}")
                + f" ms stream  {row['share'] * 100:5.1f}% of frame")
        counts = {k: n for k, n in row["launches"].items() if n}
        if counts:
            line += "  " + ", ".join(f"{k} x{n:g}" for k, n in counts.items())
        lines.append(line)
    return "\n".join(lines)
