"""Host milliseconds a frame the program's ISP took to issue its work:
the host clock of its ``isp`` spans (``isp/pipeline.py::isp_process``, 17
calls a frame) in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "isp", "host")
