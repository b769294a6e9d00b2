"""Device milliseconds a frame keeps the device busy: the union of the
trace's kernels, copies and fills in the traced window, over the frames.
Unlike the idle share, the profiler's host overhead does not move it."""


def read(data):
    if data.busy_s <= 0 or not data.frames:
        return None
    return 1e3 * data.busy_s / data.frames
