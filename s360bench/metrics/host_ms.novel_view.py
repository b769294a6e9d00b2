"""Host milliseconds a frame the program took to issue its ``novel_view``
stage: the host clock of its ``novel_view`` spans in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "novel_view", "host")
