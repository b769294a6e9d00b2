"""Host seconds of the program's static remap plans: its ``setup.plan``
spans (the misses of ``RenderContext.static_plan`` and the cubemap's
plans), summed over the process; part of set-up."""

from s360bench.spans import setup_seconds


def read(data):
    return setup_seconds("setup.plan")
