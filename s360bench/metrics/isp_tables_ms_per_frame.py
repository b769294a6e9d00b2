"""Host milliseconds a frame of the ISP's tables: the host clock of its
``isp.tables`` spans (Bayer masks, vignette gains, colour tables and their
uploads, in each ``isp_process`` call) in the traced window."""

from s360bench.spans import span_ms


def read(data):
    return span_ms(data, "isp.tables", "host")
