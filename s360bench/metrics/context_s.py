"""Host seconds of the program's render context: its ``setup.context``
span (``render/panorama.py::build_render_context``), part of set-up."""

from s360bench.spans import setup_seconds


def read(data):
    return setup_seconds("setup.context")
