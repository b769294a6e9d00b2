"""Device kernels a frame launches: the kernels of the profiler's trace of
the traced frames, over the frames."""


def read(data):
    if not data.kernels or not data.frames:
        return None
    return len(data.kernels) / data.frames
