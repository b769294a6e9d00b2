"""Host milliseconds a frame the program took to issue its ``output``
stage: the host clock of its ``output`` spans in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "output", "host")
