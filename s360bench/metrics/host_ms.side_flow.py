"""Host milliseconds a frame the program took to issue its ``side_flow``
stage: the host clock of its ``side_flow`` spans in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "side_flow", "host")
