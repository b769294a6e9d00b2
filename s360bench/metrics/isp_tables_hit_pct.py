"""Share of the program's ISP calls that found their tables on the
device, in percent: of the ``isp.tables`` spans the program's tracer
recorded in the traced frames, those that counted ``isp.tables.hit``.
None where the program has no tracer or no such span counts a hit or a
miss (``isp.tables.miss``)."""


def read(data):
    try:
        from surround360_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = [s for s in tracing.session() if s.name == "isp.tables" and s.end_ns is not None]
    hits = [s.counts.get("isp.tables.hit", 0) > 0 for s in spans]
    counted = [h or s.counts.get("isp.tables.miss", 0) > 0 for h, s in zip(hits, spans)]
    if not any(counted):
        return None
    return 100.0 * sum(hits) / len(spans)
