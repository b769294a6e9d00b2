"""Math helpers (port of ``surround360_tpu/utils/math_util.py``;
reference: surround360_render/source/util/MathUtil.h). The reference's
``xp=`` switch between numpy and jax.numpy becomes a dispatch on the
argument's type: :func:`clamp`, :func:`reflect`, :func:`wrap` and
:func:`gaussian_approx` take torch tensors or numpy arrays (and scalars,
as numpy), :func:`ramp` and :func:`median` take tensors; the Bezier
curves are host precompute on numpy arrays. :func:`disable_tf32` holds
the port's float32 precision."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "clamp",
    "lerp",
    "bilerp",
    "reflect",
    "wrap",
    "ramp",
    "to_radians",
    "to_degrees",
    "gaussian_approx",
    "bezier_curve",
    "bezier_curve_batch",
    "median",
    "disable_tf32",
    "fma_f32",
]


# True only in the precision control (``s360bench/control.py``): the
# reference's products and convolutions then run in TF32
ALLOW_TF32 = False


def disable_tf32() -> None:
    """Float32 products and convolutions in float32, not TF32 (unless
    :data:`ALLOW_TF32`). Called by every entry point and every function
    that runs a float32 product or convolution on the device."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it, on any device: the product of two float32 values is exact in
    float64; the float64 sum is made round-to-odd (TwoSum gives its error,
    and an inexact sum with an even last bit steps one ulp toward the
    exact value), so its rounding to float32 is that of the exact value."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def clamp(x, lo, hi):
    """Clamp x into [lo, hi] (MathUtil.h: clamp): min(max(x, lo), hi)."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return np.minimum(np.maximum(x, lo), hi)


def bilerp(x00, x10, x01, x11, tx, ty):
    """Bilinear interpolation of 4 corner values (MathUtil.h: bilerp)."""
    return lerp(lerp(x00, x10, tx), lerp(x01, x11, tx), ty)


def reflect(x, n):
    """Reflecting (mirror) boundary fold of x into [0, n) (MathUtil.h:
    reflect): -1 -> 0, n -> n - 1; exact for x in [-n, 2n)."""
    where = torch.where if isinstance(x, torch.Tensor) else np.where
    x = where(x < 0, -x - 1, x)
    return where(x >= n, 2 * n - 1 - x, x)


def wrap(x, n):
    """Periodic boundary fold of x into [0, n) (MathUtil.h: wrap), the
    floored modulo (the result has the sign of n)."""
    if isinstance(x, torch.Tensor):
        return torch.remainder(x, n)
    return np.mod(x, n)


def to_radians(deg):
    return deg * (np.pi / 180.0)


def to_degrees(rad):
    return rad * (180.0 / np.pi)


def gaussian_approx(x, mean, std):
    """Cubic approximation of a gaussian bump (the reference's
    GaussianApproximation functor, MathUtil.h:148-184): 1 at ``mean``,
    falling to 0 at +-2 std, as (1 - smoothstep)^2, without
    transcendentals."""
    absolute = torch.abs if isinstance(x, torch.Tensor) else np.abs
    t = clamp(absolute(x - mean) / (2.0 * std), 0.0, 1.0)
    s = 1.0 - t * t * (3.0 - 2.0 * t)  # 1 - smoothstep
    return s * s


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
