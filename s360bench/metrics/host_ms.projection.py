"""Host milliseconds a frame the program took to issue its ``projection``
stage: the host clock of its ``projection`` spans in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "projection", "host")
