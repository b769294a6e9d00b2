"""IIR low-pass / unsharp sharpening / median filtering.

Port of ``surround360_tpu/ops/filters.py`` (reference:
surround360_render/source/util/Filter.h). The causal + anti-causal
exponential IIR of ``iirLowPass`` (Filter.h:40-94) equals a convolution
with the two-sided kernel a^|n| (normalised), truncated where a^r < 1e-7;
it is applied as a banded matrix product on short axes and as a 1-D
convolution on long ones, exactly as the reference does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import resize
from .resize import conv_separable_1d, matmul_batched, on_device

__all__ = [
    "iir_lowpass_2d",
    "sharpen_iir",
    "median_filter",
    "median_filter_5x5_separable",
]


@lru_cache(maxsize=128)
def _iir_band_matrix(n: int, alpha: float, boundary: str) -> np.ndarray:
    """(n, n) matrix equal to the causal*anticausal exponential IIR."""
    if alpha <= 0:
        return np.eye(n, dtype=np.float32)
    radius = int(min(n - 1, np.ceil(np.log(1e-7) / np.log(alpha))))
    xs = np.arange(-radius, radius + 1)
    k = alpha ** np.abs(xs)
    k = k / k.sum()
    m = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for off, w in zip(xs, k):
        j = idx + off
        if boundary == "wrap":
            j = np.mod(j, n)
        else:  # reflect
            j = np.abs(j)
            j = np.where(j >= n, np.clip(2 * (n - 1) - j, 0, n - 1), j)
        np.add.at(m, (idx, j), w)
    return m.astype(np.float32)


def iir_lowpass_2d(
    img: torch.Tensor,
    amount: float,
    h_boundary: str = "reflect",
    v_boundary: str = "reflect",
) -> torch.Tensor:
    """Two-direction exponential low-pass of (..., H, W); per-pass
    alpha = amount ** 0.25 (Filter.h:48)."""
    alpha = float(amount) ** 0.25
    H, W = img.shape[-2:]
    img = img.float()
    if max(H, W) >= resize.CONV_MIN_AXIS and alpha > 0:

        def axis_kernel(n):
            radius = int(min(n - 1, np.ceil(np.log(1e-7) / np.log(alpha))))
            xs = np.arange(-radius, radius + 1)
            k = alpha ** np.abs(xs)
            return k / k.sum()

        out = conv_separable_1d(img, axis_kernel(H), v_boundary, -2)
        return conv_separable_1d(out, axis_kernel(W), h_boundary, -1)
    rm = on_device(_iir_band_matrix, img.device, H, alpha, v_boundary)
    cm = on_device(_iir_band_matrix, img.device, W, alpha, h_boundary)
    return matmul_batched(rm, img, cm.T)


def sharpen_iir(
    img: torch.Tensor,
    amount: float,
    noise_core: float = 100.0,
    h_boundary: str = "reflect",
    v_boundary: str = "reflect",
    iir_amount: float = 0.25,
) -> torch.Tensor:
    """IIR unsharp mask with noise coring on (..., H, W) images in [0,1]
    (sharpenWithIirLowPass, Filter.h:97-127, maxVal=1; hp^2 is scaled by
    255^2 so the reference's noiseCore values carry over)."""
    if not 0.0 <= iir_amount < 1.0:
        raise ValueError("iir_amount must be in [0, 1)")
    img = img.float()
    lp = iir_lowpass_2d(img, iir_amount, h_boundary=h_boundary, v_boundary=v_boundary)
    hp = img - lp
    gain = 1.0 - torch.exp(-(hp * hp) * (noise_core * 65025.0))
    return torch.clamp(lp + hp * gain * amount, 0.0, 1.0)


def _median5(a, b, c, d, e):
    """Exact median of 5 via a 7-op min/max network."""
    f = torch.maximum(torch.minimum(a, b), torch.minimum(c, d))
    g = torch.minimum(torch.maximum(a, b), torch.maximum(c, d))
    return torch.maximum(torch.minimum(torch.maximum(f, g), e), torch.minimum(f, g))


def _edge_pad(img: torch.Tensor, py: int, px: int) -> torch.Tensor:
    lead = img.shape[:-2]
    flat = img.reshape((-1, 1) + img.shape[-2:])
    out = F.pad(flat, (px, px, py, py), mode="replicate")
    return out.reshape(lead + out.shape[-2:])


def median_filter_5x5_separable(img: torch.Tensor) -> torch.Tensor:
    """Median of row medians: two 5-tap median networks (the flow's final
    smoother in the pixflow_tpu preset). Edge replication."""
    img = img.float()
    H, W = img.shape[-2:]
    p = _edge_pad(img, 0, 2)
    rows = _median5(*[p[..., :, k : k + W] for k in range(5)])
    p = _edge_pad(rows, 2, 0)
    return _median5(*[p[..., k : k + H, :] for k in range(5)])


def median_filter(img: torch.Tensor, size: int = 5) -> torch.Tensor:
    """size x size median of (..., H, W) with edge replication."""
    if size % 2 != 1:
        raise ValueError("median size must be odd")
    r = size // 2
    img = img.float()
    padded = _edge_pad(img, r, r)
    H, W = img.shape[-2:]
    shifts = [
        padded[..., dy : dy + H, dx : dx + W]
        for dy in range(size)
        for dx in range(size)
    ]
    # size*size is odd, so the middle order statistic is the exact median
    return torch.stack(shifts, dim=0).median(dim=0).values
