"""Device milliseconds of the ISP a frame: the trace's kernels launched
inside the benchmark's ``s360bench.isp`` spans (17 ``isp_process`` calls
a frame), over the frames."""


def read(data):
    if data.isp_kernel_s <= 0 or not data.frames:
        return None
    return 1e3 * data.isp_kernel_s / data.frames
