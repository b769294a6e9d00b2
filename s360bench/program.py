"""The system under test: ``surround360_tpu_torch``'s renderer and ISP.

The benchmark takes from the program only these entries, its kernels'
names in the device trace and its per-call record of the hand kernels
(``ops/fused_window.py``). :class:`Program` and the reference's
``reference/system.py::Reference`` have one interface, so the precision
control can stand in the program's place.
"""

from __future__ import annotations

import contextlib

from .reference.system import tuples


class Program:
    """``render/panorama.py::make_jitted_renderer(build_render_context(rig,
    cfg), use_temporal=...)``, frame 0 without a prior and every later
    frame chained, and ``isp/pipeline.py::isp_process`` per camera."""

    def __init__(self, config: dict, device):
        from surround360_tpu_torch.geometry.rig import make_ring_rig
        from surround360_tpu_torch.isp.pipeline import IspConfig, isp_process
        from surround360_tpu_torch.render.panorama import (
            RenderConfig,
            build_render_context,
            make_jitted_renderer,
        )

        self.rig = make_ring_rig(**{k: tuples(v) for k, v in config["rig"].items()})
        self.ctx = build_render_context(self.rig, RenderConfig(**config["render"]))
        self._first = make_jitted_renderer(self.ctx, use_temporal=False)
        self._next = make_jitted_renderer(self.ctx, use_temporal=True)
        self._isp, self._isp_config = isp_process, IspConfig
        self._isp_cfgs: dict = {}

    def first(self, side, top, bottom):
        return self._first(side, top, bottom, None)

    def next(self, side, top, bottom, state):
        return self._next(side, top, bottom, state)

    def isp(self, raw, kw: dict):
        key = tuple(sorted(kw.items()))  # a camera's ISP settings differ by seed
        cfg = self._isp_cfgs.get(key)
        if cfg is None:
            cfg = self._isp_cfgs[key] = self._isp_config(**kw)
        return self._isp(raw, cfg)


@contextlib.contextmanager
def kernel_calls(sink: list):
    """Every launch of the program's windowed-sampling kernels while open,
    appended to ``sink`` as (kernel, args, kwargs): the program's own
    per-call hook (``fused_window._record``), which otherwise keeps only
    each site's largest call."""
    from surround360_tpu_torch.ops import fused_window as fw

    hook = fw._record

    def record(kernel, site, args, kw, out):
        sink.append((kernel, args, kw))
        hook(kernel, site, args, kw, out)

    fw._record = record
    try:
        yield
    finally:
        fw._record = hook


# the program's kernel names (ops/fused_window.py) -> the names the
# device trace gives their CUDA functions (csrc/)
KERNEL_TRACE_NAMES = {
    "fused_window_sample": "window_sample_kernel",
    "fused_window_offsets": "window_offsets_kernel",
}
