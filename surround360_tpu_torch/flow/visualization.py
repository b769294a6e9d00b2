"""Flow-field visualizations.

Port of ``surround360_tpu/flow/visualization.py`` (reference:
surround360_render/source/optical_flow/OpticalFlowVisualization.h:21-32):
grey disparity rendering, HSV color-wheel rendering, and the color-wheel
legend. Host numpy (debug tooling, not a hot path); flows may be numpy
arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "visualize_flow_disparity",
    "visualize_flow_color_wheel",
    "color_wheel_legend",
]


def _host(flow) -> np.ndarray:
    if isinstance(flow, torch.Tensor):
        return flow.detach().cpu().numpy()
    return np.asarray(flow)


def visualize_flow_disparity(flow, max_disparity: float | None = None):
    """|flow_x| as grey levels -> (3, H, W) float32 (the reference's
    horizontal-disparity rendering)."""
    mag = np.abs(_host(flow)[0])
    scale = max_disparity or max(float(mag.max()), 1e-6)
    grey = np.clip(mag / scale, 0.0, 1.0).astype(np.float32)
    return np.stack([grey] * 3)


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return r, g, b


def visualize_flow_color_wheel(flow, max_mag: float | None = None):
    """Direction -> hue, magnitude -> value (HSV color-wheel rendering).
    flow (2, H, W) -> (3, H, W) float32 RGB."""
    flow = _host(flow)
    angle = np.arctan2(flow[1], flow[0])  # [-pi, pi]
    mag = np.hypot(flow[0], flow[1])
    scale = max_mag or max(float(mag.max()), 1e-6)
    h = (angle + np.pi) / (2.0 * np.pi)
    v = np.clip(mag / scale, 0.0, 1.0)
    r, g, b = _hsv_to_rgb(h, np.ones_like(h), v)
    return np.stack([r, g, b]).astype(np.float32)


def color_wheel_legend(size: int = 256):
    """The circular legend image for the color-wheel rendering."""
    ys, xs = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    img = visualize_flow_color_wheel(np.stack([xs, ys]), max_mag=1.0)
    mask = (xs * xs + ys * ys) <= 1.0
    return (img * mask).astype(np.float32)
