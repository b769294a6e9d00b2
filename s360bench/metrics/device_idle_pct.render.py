"""Share of the traced window in which no kernel, copy or fill runs on the
device, from the profiler's device activity."""


def read(data):
    if data.window_s <= 0 or data.busy_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
