"""Alpha compositing / deghosting / panorama assembly primitives.

Port of the renderer's and pole removal's parts of
``surround360_tpu/ops/compositing.py``
(reference: surround360_render/source/util/CvUtil.cpp) as elementwise
torch on channels-first (..., 4, H, W) RGBA float32 in [0,1].
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import gaussian_blur

__all__ = [
    "stack_horizontal",
    "stack_vertical",
    "offset_horizontal_wrap",
    "feather_alpha",
    "circle_alpha_cut",
    "cut_mask_out_of_alpha",
    "radial_alpha_fade",
    "top_down_alpha_fade",
    "flatten_layers_deghost_prefer_base",
    "flatten_layers_alpha_softmax",
]


def stack_horizontal(images) -> torch.Tensor:
    """Concat along width (CvUtil.cpp:69-79)."""
    return torch.cat(list(images), dim=-1)


def stack_vertical(images) -> torch.Tensor:
    """Concat along height (CvUtil.cpp:81-91)."""
    return torch.cat(list(images), dim=-2)


def offset_horizontal_wrap(image: torch.Tensor, offset) -> torch.Tensor:
    """Shift horizontally with wrap-around (CvUtil.cpp:93-115); fractional
    offsets blend the two neighbouring integer shifts."""
    offset = float(offset)
    i = int(np.floor(offset))
    frac = offset - i
    rolled = torch.roll(image, i, dims=-1)
    if frac == 0.0:
        return rolled
    return rolled * (1.0 - frac) + torch.roll(image, i + 1, dims=-1) * frac


def _min_filter_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Running min over a (2*radius+1) window via log-doubling shifted mins
    with edge replication (the reference's construction, same values)."""
    axis = axis % x.ndim
    n = x.shape[axis]

    def shift(t, step, forward):
        # value at i becomes t[i - step] (forward) or t[i + step], edge-held
        if forward:
            edge = t.narrow(axis, 0, 1).expand_as(t.narrow(axis, 0, step))
            return torch.cat([edge, t.narrow(axis, 0, n - step)], dim=axis)
        edge = t.narrow(axis, n - 1, 1).expand_as(t.narrow(axis, 0, step))
        return torch.cat([t.narrow(axis, step, n - step), edge], dim=axis)

    def directional(forward):
        out = x
        covered = 1
        while covered <= radius:
            step = min(covered, radius - covered + 1)
            if step >= n:
                step_t = out.narrow(axis, 0 if forward else n - 1, 1)
                out = torch.minimum(out, step_t.expand_as(out))
            else:
                out = torch.minimum(out, shift(out, step, forward))
            covered += step
        return out

    return torch.minimum(directional(True), directional(False))


def _erode_cross(alpha: torch.Tensor, radius: int) -> torch.Tensor:
    """Erosion by a cross of given radius (MORPH_CROSS, CvUtil.cpp:140-157):
    min over the union of the horizontal and vertical 1-D windows."""
    return torch.minimum(
        _min_filter_1d(alpha, radius, -1), _min_filter_1d(alpha, radius, -2)
    )


def feather_alpha(image: torch.Tensor, erode_size: int = 3) -> torch.Tensor:
    """Erode then blur the alpha channel (CvUtil.cpp:140-157)."""
    alpha = image[..., 3, :, :]
    alpha = _erode_cross(alpha, erode_size)
    alpha = gaussian_blur(alpha, erode_size / 2.0)
    return _with_alpha(image, alpha)


def _with_alpha(image: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.cat([image[..., :3, :, :], alpha[..., None, :, :]], dim=-3)


def circle_alpha_cut(image: torch.Tensor, radius: float) -> torch.Tensor:
    """Alpha = 1 inside a centered circle of ``radius`` px, 0 outside
    (CvUtil.cpp:201-211)."""
    H, W = image.shape[-2:]
    ys = torch.arange(H, dtype=torch.float32, device=image.device)[:, None] - H / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=image.device)[None, :] - W / 2.0
    inside = (ys * ys + xs * xs) < (radius * radius)
    alpha = inside.to(image.dtype).expand(image[..., 3, :, :].shape)
    return _with_alpha(image, alpha)


def cut_mask_out_of_alpha(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero alpha where ``mask`` (H, W) bool is set (the red-pole-mask cut,
    CvUtil.cpp:213-222)."""
    alpha = image[..., 3, :, :]
    return _with_alpha(image, torch.where(mask, torch.zeros_like(alpha), alpha))


def radial_alpha_fade(image: torch.Tensor) -> torch.Tensor:
    """Multiply alpha by max(0, 1 - r/rmax) from the center
    (CvUtil.cpp:312-325)."""
    H, W = image.shape[-2:]
    ys = torch.arange(H, dtype=torch.float32, device=image.device)[:, None] - H / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=image.device)[None, :] - W / 2.0
    r = torch.sqrt(ys * ys + xs * xs) / (min(H, W) / 2.0)
    fade = torch.clamp(1.0 - r, min=0.0)
    return _with_alpha(image, image[..., 3, :, :] * fade)


def top_down_alpha_fade(image: torch.Tensor) -> torch.Tensor:
    """Multiply alpha by y/H (CvUtil.cpp:327-334)."""
    H = image.shape[-2]
    fade = (torch.arange(H, dtype=torch.float32, device=image.device) / H)[:, None]
    return _with_alpha(image, image[..., 3, :, :] * fade)


def flatten_layers_deghost_prefer_base(
    bottom: torch.Tensor, top: torch.Tensor
) -> torch.Tensor:
    """Two-layer softmax deghost with base-layer bias (CvUtil.cpp:224-260):
    kColorDiffCoef=5, kSoftmaxSharpness=5, kBaseLayerBias=2."""
    k_color_diff_coef = 5.0
    k_sharpness = 5.0
    k_base_bias = 2.0

    base_rgb = bottom[..., :3, :, :]
    top_rgb = top[..., :3, :, :]
    color_diff = torch.sum(torch.abs(base_rgb - top_rgb), dim=-3)
    deghost = torch.tanh(color_diff * k_color_diff_coef)

    alpha_r = top[..., 3, :, :]
    alpha_l = 1.0 - alpha_r
    exp_l = torch.exp(k_sharpness * alpha_l * k_base_bias)
    exp_r = torch.exp(k_sharpness * alpha_r)
    sum_exp = exp_l + exp_r + 1e-5
    softmax_l = exp_l / sum_exp
    softmax_r = 1.0 - softmax_l

    w_l = alpha_l + deghost * (softmax_l - alpha_l)
    w_r = alpha_r + deghost * (softmax_r - alpha_r)
    out_rgb = base_rgb * w_l[..., None, :, :] + top_rgb * w_r[..., None, :, :]
    out_a = torch.maximum(top[..., 3, :, :], bottom[..., 3, :, :])
    return torch.cat([out_rgb, out_a[..., None, :, :]], dim=-3)


def flatten_layers_alpha_softmax(
    layers: torch.Tensor, softmax_coef: float = 5.0
) -> torch.Tensor:
    """Blend N RGBA layers with weights exp(coef * alpha) - 1
    (CvUtil.cpp:336-361). ``layers`` is (N, ..., 4, H, W); returns RGB
    (..., 3, H, W)."""
    w = torch.exp(softmax_coef * layers[..., 3:4, :, :]) - 1.0
    num = torch.sum(w * layers[..., :3, :, :], dim=0)
    den = torch.sum(w, dim=0)
    return num / torch.where(den == 0, torch.ones_like(den), den)
