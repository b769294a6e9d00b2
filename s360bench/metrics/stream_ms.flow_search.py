"""Stream milliseconds a frame of the hinted search in front of the
coarsest pyramid level of the program's flow: the CUDA events of the
``flow.search`` spans, over every flow call of the traced frames (three a
frame at 6k: the ring's two directions and the poles)."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "flow.search", "stream")
