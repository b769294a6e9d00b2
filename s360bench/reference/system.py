"""The plain reference with the program's interface (``program.py``):
frame 0 without a prior, later frames from a given state, the ISP per
camera. ``tf32=True`` is the precision control: the same reference with
its float32 products and convolutions in TF32."""

from __future__ import annotations

from . import math_util
from .isp import IspConfig, isp_process
from .panorama import RenderConfig, build_render_context, render_frame
from .rig import make_ring_rig


def tuples(v):
    """JSON lists -> tuples, nested (the configs' dataclasses hash them)."""
    return tuple(tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


class Reference:
    def __init__(self, config: dict, device=None, tf32: bool = False):
        self.tf32 = tf32
        self.rig = make_ring_rig(**{k: tuples(v) for k, v in config["rig"].items()})
        self.ctx = build_render_context(self.rig, RenderConfig(**config["render"]))
        self._isp_cfgs: dict = {}

    def first(self, side, top, bottom):
        math_util.ALLOW_TF32 = self.tf32
        return render_frame(self.ctx, side, top, bottom, state=None, use_temporal=False)

    def next(self, side, top, bottom, state):
        math_util.ALLOW_TF32 = self.tf32
        return render_frame(self.ctx, side, top, bottom, state=state, use_temporal=True)

    def isp(self, raw, kw: dict):
        math_util.ALLOW_TF32 = self.tf32
        key = tuple(sorted(kw.items()))  # a camera's ISP settings differ by seed
        cfg = self._isp_cfgs.get(key)
        if cfg is None:
            cfg = self._isp_cfgs[key] = IspConfig(**kw)
        return isp_process(raw, cfg)
