"""Math helpers (port of the renderer's and the ISP's use of
``surround360_tpu/utils/math_util.py``; reference:
surround360_render/source/util/MathUtil.h). :func:`ramp` takes torch
tensors, as does :func:`median`; the Bezier curves are host precompute
on numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ramp", "lerp", "bezier_curve", "bezier_curve_batch", "median"]


def ramp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """0 below lo, 1 above hi, linear in between (MathUtil.h: rampf)."""
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)


def median(x: torch.Tensor) -> float:
    """np.median of all of ``x``: the mean of the two middle values of an
    even count (``torch.median`` returns the lower one); NaN when empty."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n == 0:
        return float("nan")
    if n % 2:
        return float(s[n // 2])
    return float((s[n // 2 - 1].double() + s[n // 2].double()) / 2)


def lerp(a, b, t):
    """Linear interpolation a + t*(b-a) (MathUtil.h: lerpf/lerp)."""
    return a + t * (b - a)


def _de_casteljau(pts, t):
    while len(pts) > 1:
        pts = [lerp(pts[i], pts[i + 1], t) for i in range(len(pts) - 1)]
    return pts[0]


def bezier_curve(points, t):
    """A Bezier curve at parameter ``t`` (scalar or array) by the De
    Casteljau recurrence (MathUtil.h:187-216). ``points``: a sequence of
    control values, scalars or arrays broadcastable against ``t``."""
    return _de_casteljau([np.asarray(p) for p in points], t)


def bezier_curve_batch(ctrl, t):
    """Vectorized De Casteljau: ``ctrl`` has shape (..., n_ctrl); ``t`` is
    broadcastable against ``ctrl[..., 0]``."""
    ctrl = np.asarray(ctrl)
    return _de_casteljau([ctrl[..., i] for i in range(ctrl.shape[-1])], t)
