"""K1 (the windowed sampler, ``fused_window_sample``) against the HBM
roofline: the least bytes of its calls in the traced frames
(``bounds.call_bytes``, from the program's per-call record in a replay of
those frames) at 3.35 TB/s, over its device time in the trace."""

from s360bench.bounds import HBM_BYTES_PER_S
from s360bench.trace import kernel_seconds

KERNEL = "fused_window_sample"


def read(data):
    nbytes = data.call_bytes.get(KERNEL, 0)
    seconds = kernel_seconds(data, KERNEL)
    if nbytes <= 0 or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
