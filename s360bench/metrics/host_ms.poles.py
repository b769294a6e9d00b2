"""Host milliseconds a frame the program took to issue its ``poles``
stage: the host clock of its ``poles`` spans in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "poles", "host")
