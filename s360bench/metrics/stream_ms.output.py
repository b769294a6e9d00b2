"""Stream milliseconds a frame of the program's ``output`` stage: the
CUDA events of its ``output`` spans in the traced window, from the
stage's first operation on the stream to its last, waiting for the host
included."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "output", "stream")
