"""Math helpers for torch tensors (port of the renderer's use of
``surround360_tpu/utils/math_util.py``; reference:
surround360_render/source/util/MathUtil.h)."""

from __future__ import annotations

import torch

__all__ = ["ramp"]


def ramp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """0 below lo, 1 above hi, linear in between (MathUtil.h: rampf)."""
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
