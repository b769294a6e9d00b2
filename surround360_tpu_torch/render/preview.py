"""Fast live-preview renderer.

Port of ``surround360_tpu/render/preview.py`` (reference:
surround360_render/source/test/TestHyperPreview.cpp): the three fisheye
cameras (top, bottom, secondary bottom) are 2x2-block demosaiced at half
scale, gamma'd, alpha-faded (radial, plus top-down for the bottom
cameras), remapped through precomputed equirect warps by one dense bicubic
remap, and composited with the alpha-softmax blend.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..cli.common import resolve_device
from ..geometry.camera import create_rescaled_camera
from ..geometry.rig import Rig
from ..ops.compositing import (
    flatten_layers_alpha_softmax,
    radial_alpha_fade,
    top_down_alpha_fade,
)
from ..ops.remap import remap
from ..ops.warp import equirect_to_cam_warp

__all__ = ["PreviewRenderer", "simple_demosaic"]


def simple_demosaic(raw: torch.Tensor, gamma: float = 0.4545, pattern: str = "GBRG"):
    """2x2-block demosaic at half scale (TestHyperPreview.cpp:163-184).
    raw: (..., H, W) float in [0,1] -> (..., 3, H/2, W/2)."""
    tl = raw[..., 0::2, 0::2]
    tr = raw[..., 0::2, 1::2]
    bl = raw[..., 1::2, 0::2]
    br = raw[..., 1::2, 1::2]
    if pattern == "GBRG":
        r, g, b = bl, (tl + br) / 2.0, tr
    elif pattern == "GRBG":
        r, g, b = tr, (tl + br) / 2.0, bl
    elif pattern == "RGGB":
        r, g, b = tl, (tr + bl) / 2.0, br
    elif pattern == "BGGR":
        r, g, b = br, (tr + bl) / 2.0, tl
    else:
        raise ValueError(pattern)
    rgb = torch.stack([r, g, b], dim=-3)
    return torch.pow(torch.clamp(rgb, min=0.0), gamma)


class PreviewRenderer(nn.Module):
    """The preview of one rig at ``eqr_width`` x ``eqr_height``. The three
    cameras' warps are built on the host at construction and held as the
    buffer ``warps`` (3, 2, eqr_height, eqr_width) on ``device``
    (``cuda`` unless the caller asks for the CPU)."""

    def __init__(
        self,
        rig: Rig,
        eqr_width: int = 1024,
        eqr_height: int = 512,
        softmax_coef: float = 5.0,
        gamma: float = 0.4545,
        bayer_pattern: str = "GBRG",
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(str(device))
        self.rig = rig
        self.eqr_width = eqr_width
        self.eqr_height = eqr_height
        self.softmax_coef = softmax_coef
        self.gamma = gamma
        self.bayer_pattern = bayer_pattern
        # top, bottom, secondary bottom at half scale
        # (TestHyperPreview.cpp:83-96)
        idxs = [rig.top_camera_index, rig.bottom_camera_index, rig.bottom_camera2_index]
        self.cameras = [create_rescaled_camera(rig.cameras[i], 0.5) for i in idxs]
        # equirect warp with theta = 2 pi (1 - x/W), phi = pi y/H
        # (precomputeProjectionWarp, TestHyperPreview.cpp:117-129): that is
        # equirect_to_cam_warp's convention mirrored in x
        warps = np.stack([
            equirect_to_cam_warp(cam, (eqr_height, eqr_width), 1.0e6)[:, :, ::-1]
            for cam in self.cameras
        ])
        self.register_buffer("warps", torch.from_numpy(warps).to(self.device))

    @torch.no_grad()
    def forward(self, raws: torch.Tensor) -> torch.Tensor:
        """raws: (3, H, W) raw mosaics of top/bottom/bottom2 in [0,1] ->
        (3, eqr_height, eqr_width) RGB."""
        rgb = simple_demosaic(raws, self.gamma, self.bayer_pattern)
        rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=1)
        # the bottom cameras get the top-down fade first, then all radial
        layers = torch.stack([
            radial_alpha_fade(top_down_alpha_fade(rgba[i]) if i > 0 else rgba[i])
            for i in range(3)
        ])
        projected = remap(layers, self.warps, interpolation="bicubic", border="constant")
        return flatten_layers_alpha_softmax(projected, self.softmax_coef)

    def render(self, top_raw, bottom_raw, bottom2_raw) -> torch.Tensor:
        """Raw mosaics (H, W) in [0,1], numpy arrays or tensors ->
        (3, eqr_h, eqr_w) preview on the renderer's device."""
        raws = torch.stack([
            torch.as_tensor(r, dtype=torch.float32).to(self.device)
            for r in (top_raw, bottom_raw, bottom2_raw)
        ])
        return self(raws)
