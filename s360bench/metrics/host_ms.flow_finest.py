"""Host milliseconds a frame the program took to issue the finest pyramid
level of the program's flow: the host clock of the ``flow.level`` spans
with ``finest`` True, over every flow call of the traced frames."""

from s360bench.spans import flow_level_ms


def read(data):
    return flow_level_ms(data, True, "host")
