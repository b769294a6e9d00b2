"""Share of the program's flow pyramid levels that ran as CUDA graphs, in
percent: of the ``flow.level`` spans the program's tracer recorded in the
traced frames, those whose ``graphed`` attribute is true. None where the
program has no tracer or no level span carries the attribute."""


def read(data):
    try:
        from surround360_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = [s for s in tracing.session() if s.name == "flow.level" and s.end_ns is not None]
    flags = [s.attrs.get("graphed") for s in spans]
    if not flags or any(f is None for f in flags):
        return None
    return 100.0 * sum(1 for f in flags if f) / len(flags)
