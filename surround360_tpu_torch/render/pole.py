"""Pole removal: merge the two bottom cameras to erase the tripod.

Port of ``surround360_tpu/render/pole.py`` (reference:
surround360_render/source/render/PoleRemoval.{h,cpp}). The reference's
per-frame mask and flow files are tensors here; the CLI layer owns the IO.
"""

from __future__ import annotations

import torch

from ..flow import HINT_DOWN, compute_flow
from ..ops.compositing import circle_alpha_cut, cut_mask_out_of_alpha, feather_alpha
from ..ops.window_sampler import sample_displaced

__all__ = ["combine_bottom_images_with_pole_removal"]


def combine_bottom_images_with_pole_removal(
    bottom_rgba,
    bottom2_rgba,
    pole_mask,
    pole_mask2,
    usable_radius: float,
    usable_radius2: float,
    flip180: bool,
    flow_params,
    alpha_feather_size: int = 31,
    prev_flow=None,
    prev_bottom=None,
    prev_bottom2=None,
    use_temporal: bool = False,
):
    """Combine primary+secondary bottom images (PoleRemoval.cpp:32-188).

    bottom_rgba / bottom2_rgba: (4, H, W) RGBA float32 tensors (alpha
    ignored on input). pole_mask / pole_mask2: (H, W) bool (tensor or
    numpy), True where the pole is. Returns ((4, H, W) combined image, flow
    (2, H, W) for the next frame's temporal prior), on the images' device.
    """
    dev = bottom_rgba.device
    as_mask = lambda m: torch.as_tensor(m, dtype=torch.bool, device=dev)
    # alpha from usable radius, cut pole masks, feather (PoleRemoval.cpp:68-80)
    img1 = circle_alpha_cut(bottom_rgba, usable_radius)
    img2 = circle_alpha_cut(bottom2_rgba, usable_radius2)
    img1 = cut_mask_out_of_alpha(img1, as_mask(pole_mask))
    img2 = cut_mask_out_of_alpha(img2, as_mask(pole_mask2))
    img1 = feather_alpha(img1, alpha_feather_size)
    img2 = feather_alpha(img2, alpha_feather_size)

    if flip180:  # PoleRemoval.cpp:82-85
        img2 = torch.flip(img2, dims=(-2, -1))

    # optical flow secondary -> aligned with primary (PoleRemoval.cpp:108-118)
    flow = compute_flow(
        img1[None],
        img2[None],
        flow_params,
        hint=torch.tensor([HINT_DOWN], dtype=torch.int32, device=dev),
        prev_flow=None if prev_flow is None else prev_flow[None],
        prev_img0=None if prev_bottom is None else prev_bottom[None],
        prev_img1=None if prev_bottom2 is None else prev_bottom2[None],
        use_temporal=use_temporal,
        site="pole_removal_flow",
    )[0]

    # warp secondary by the flow (PoleRemoval.cpp:130-146). The flow is a
    # blurred alignment field bounded by the two cameras' baseline
    # parallax: clamp it to 10%-of-frame halos and sample static windows
    H, W = img1.shape[-2:]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    halo_y = max(32, int(0.10 * H))
    halo_x = max(32, int(0.10 * W))
    warped2 = sample_displaced(
        img2,
        gx + torch.clamp(flow[0], -halo_x, halo_x),
        gy + torch.clamp(flow[1], -halo_y, halo_y),
        halo_y=halo_y,
        halo_x=halo_x,
        interpolation="bicubic",
        border="constant",
        tr=16,
        tc=128,
        max_window_elems=64 * 1024 * 1024,
        site="pole_removal_warp",
    )

    # blend where primary alpha < 1 and secondary has data
    # (PoleRemoval.cpp:155-179)
    a1 = img1[3]
    a2w = warped2[3]
    use_blend = (a1 < 1.0) & (a2w > 0.0)
    blended_rgb = a1[None] * img1[:3] + (1.0 - a1)[None] * warped2[:3]
    rgb = torch.where(use_blend[None], blended_rgb, img1[:3])
    alpha = torch.where(use_blend, torch.ones_like(a1), a1)
    combined = torch.cat([rgb, alpha[None]], dim=0)

    # re-cut + re-feather (PoleRemoval.cpp:180-183)
    combined = circle_alpha_cut(combined, usable_radius)
    combined = feather_alpha(combined, alpha_feather_size)
    return combined, flow
