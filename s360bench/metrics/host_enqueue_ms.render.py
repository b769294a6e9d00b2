"""Host milliseconds a call to the renderer takes to return, without a
sync: how long the host needs to issue one frame. Host clock around the
benchmark's own ``render`` call, over the untraced frames of the traced
run (the profiler slows each launch)."""


def read(data):
    if not data.host_enqueue_s:
        return None
    return 1e3 * sum(data.host_enqueue_s) / len(data.host_enqueue_s)
