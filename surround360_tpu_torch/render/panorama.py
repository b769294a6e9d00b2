"""The stereo panorama renderer: one frame, eagerly, on the device of its
inputs.

Port of ``surround360_tpu/render/panorama.py`` (reference:
surround360_render/source/test/TestRenderStereoPanorama.cpp, the
reference's production renderer). Per frame:

  side images (N,4,H,W) --(static lens warps, fused window kernel)--> strips
  ring of N pairs --(28 pair flows, any flow preset)--> novel-view chunks
  top/bottom fisheyes --(static warps)--> strips --(merged pole flow and
  displacement-following warp)--> deghost composite
  sharpen -> [cubemap faces of each eye] -> final resize -> stereo
  equirect (L over R)

Rig-static warps and chunk geometry are precomputed on the host in
float64 (:class:`RenderContext`, equal to the reference's tables). The
temporal-regularization state is a dict of tensors with the reference's
keys; :func:`state_from_numpy` / :func:`state_to_numpy` convert it, so a
state from either package can drive the next frame of the other.

The frame's stages run in spans of ``utils/tracing.py``: ``frame``
around :func:`render_frame`, and inside it ``projection``, ``side_flow``,
``novel_view``, ``poles`` (with a ``poles.strip`` per fisheye) and
``output``; ``setup.context`` and ``setup.plan`` time the host set-up.

Call :func:`render_frame` with float32 tensors; it turns TF32 off, since
the reference it is held against computes in float32. With pole removal
the caller combines the two bottom cameras first (``render.pole``) and
passes the result as ``bottom_image``. The port renders eagerly:
:func:`make_jitted_renderer` keeps the signature of the reference's jitted
and staged renderer as a plain wrapper over :func:`render_frame`, and
compiles nothing.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..flow import HINT_DOWN, compute_flow, make_flow_params
from ..geometry.camera import approximate_usable_pixels_radius, get_fov
from ..geometry.rig import Rig
from ..ops.compositing import (
    feather_alpha,
    flatten_layers_deghost_prefer_base,
    offset_horizontal_wrap,
    stack_horizontal,
)
from ..ops.filters import sharpen_iir
from ..ops.remap import plan_static_remap, remap_static_planned
from ..ops.resize import resize_area, resize_bilinear, resize_cubic
from ..ops.warp import (
    CUBEMAP_FACE_ORDER,
    equirect_to_cubemap_warp,
    rig_fov,
    side_cam_spherical_warp,
    spherical_warp_for_camera,
)
from ..ops.window_sampler import sample_displaced, sample_displaced_residual
from ..utils.math_util import disable_tf32, ramp
from ..utils.tracing import span
from ..views.novel_view import lazy_warp_columns, prepare_pair_flows, render_chunk_pair

__all__ = [
    "RenderConfig",
    "RenderContext",
    "build_render_context",
    "render_frame",
    "make_jitted_renderer",
    "state_from_numpy",
    "state_to_numpy",
    "state_to_blob",
    "state_from_blob",
]


@dataclass(frozen=True)
class RenderConfig:
    """Flags of the reference renderer (TestRenderStereoPanorama.cpp:44-70),
    with the reference package's defaults."""

    eqr_width: int = 1024
    eqr_height: int = 512
    final_eqr_width: int = 0  # 0: no final resize
    final_eqr_height: int = 0
    interpupilary_dist: float = 6.4
    zero_parallax_dist: float = 10000.0
    side_alpha_feather_size: int = 100
    std_alpha_feather_size: int = 31
    sharpening: float = 0.0
    enable_top: bool = False
    enable_bottom: bool = False
    enable_pole_removal: bool = False
    side_flow_alg: str = "pixflow_low"
    polar_flow_alg: str = "pixflow_low"
    poleremoval_flow_alg: str = "pixflow_low"
    # side pair flows on overlaps downscaled by this factor
    side_flow_scale: float = 1.0
    # pole-to-side flow on inputs downscaled by this factor
    polar_flow_scale: float = 0.25
    cubemap_width: int = 0
    cubemap_height: int = 0
    cubemap_format: str = "video"


# frames may render on several threads (parallel/mesh.py): each plan of a
# context's ``plans`` is built once, under this lock
_PLANS_LOCK = threading.Lock()


@dataclass
class RenderContext:
    """Host-precomputed, rig- and config-static tables (float64-derived
    numpy, equal to the reference's), plus a per-device cache of the
    static remap plans built from them."""

    rig: Rig
    config: RenderConfig
    side_warps: np.ndarray  # (N, 2, sh, sw)
    strip_h: int
    strip_w: int
    h_radians: float
    v_radians: float
    overlap_w: int
    chunk_w: int
    warp_cols_l: np.ndarray
    warp_cols_r: np.ndarray
    t_cols: np.ndarray
    zero_parallax_shift_px: float
    top_warp: np.ndarray | None = None
    top_h: int = 0
    bottom_warp: np.ndarray | None = None
    bottom_h: int = 0
    pole_ramp_geometry: dict = field(default_factory=dict)
    # pole removal
    bottom_usable_radius: float = 0.0
    bottom2_usable_radius: float = 0.0
    pole_flip180: bool = False
    plans: dict = field(default_factory=dict, repr=False)

    @property
    def num_side_cams(self) -> int:
        return self.rig.side_camera_count

    def static_plan(self, name: str, src_hw, device, cams: tuple | None = None):
        """The fused-kernel plan of warp ``name`` ("side", "top",
        "bottom") over sources of size src_hw, built once per device;
        ``cams`` = (start, stop) plans side cameras [start, stop) only."""
        key = (name, tuple(src_hw), str(device), cams)
        with _PLANS_LOCK:
            if key not in self.plans:
                with span("setup.plan", name=name):
                    if name == "side":
                        warps = self.side_warps if cams is None else self.side_warps[slice(*cams)]
                    else:
                        warps = getattr(self, f"{name}_warp")[None]
                    self.plans[key] = plan_static_remap(warps, *src_hw, "bicubic", device)
            return self.plans[key]


def build_render_context(rig: Rig, config: RenderConfig) -> RenderContext:
    """Precompute all rig-static warps and geometry
    (TestRenderStereoPanorama.cpp:138-175, :295-348)."""
    with span("setup.context"):
        return _build_context(rig, config)


def _build_context(rig: Rig, config: RenderConfig) -> RenderContext:
    n = rig.side_camera_count
    if config.eqr_width % n != 0:
        raise ValueError(
            f"eqr_width must be divisible by the number of side cameras ({n})"
        )
    sides = rig.side_cameras
    h_rad = 2.0 * rig_fov(sides, False)
    v_rad = 2.0 * rig_fov(sides, True)

    warps = []
    strip_hw = None
    for i, cam in enumerate(sides):
        warp, strip_hw = side_cam_spherical_warp(
            cam, i, n, (config.eqr_width, config.eqr_height), h_rad, v_rad
        )
        warps.append(warp)
    side_warps = np.stack(warps)
    sh, sw = strip_hw

    # ring geometry (TestRenderStereoPanorama.cpp:304-316)
    h_fov_deg = np.degrees(h_rad)
    overlap_deg = (h_fov_deg * n - 360.0) / n
    overlap_w = int(sw * overlap_deg / h_fov_deg)
    chunk_w = config.eqr_width // n

    # lightfield math (TestRenderStereoPanorama.cpp:339-348)
    v = np.arctan(config.zero_parallax_dist / (config.interpupilary_dist / 2.0))
    psi = np.arcsin(np.sin(v) * (config.interpupilary_dist / 2.0) / rig.ring_radius)
    verge_px = psi * (sw / h_rad)
    theta = -np.pi / 2.0 + v + psi
    zero_shift_px = config.eqr_width * theta / (2.0 * np.pi)

    wl, t_cols = lazy_warp_columns(chunk_w, sw, verge_px, "left")
    wr, _ = lazy_warp_columns(chunk_w, sw, verge_px, "right")

    ctx = RenderContext(
        rig=rig, config=config, side_warps=side_warps, strip_h=sh,
        strip_w=sw, h_radians=h_rad, v_radians=v_rad, overlap_w=overlap_w,
        chunk_w=chunk_w, warp_cols_l=wl, warp_cols_r=wr, t_cols=t_cols,
        zero_parallax_shift_px=float(zero_shift_px),
    )

    if config.enable_top:
        cam = rig.cameras[rig.top_camera_index]
        fov = get_fov(cam)
        top_h = int(config.eqr_height * fov / np.pi)
        # reversed horizontal sweep (TestRenderStereoPanorama.cpp:660-667)
        ctx.top_warp = spherical_warp_for_camera(
            cam, (top_h, config.eqr_width), 2.0 * np.pi, 0.0, np.pi / 2.0,
            np.pi / 2.0 - fov,
        )
        ctx.top_h = top_h

    if config.enable_bottom:
        cam = rig.cameras[rig.bottom_camera_index]
        fov = get_fov(cam)
        bottom_h = int(config.eqr_height * fov / np.pi)
        ctx.bottom_warp = spherical_warp_for_camera(
            cam, (bottom_h, config.eqr_width), 0.0, 2.0 * np.pi,
            -np.pi / 2.0, -(np.pi / 2.0 - fov),
        )
        ctx.bottom_h = bottom_h
        if config.enable_pole_removal:
            cam2 = rig.cameras[rig.bottom_camera2_index]
            ctx.bottom_usable_radius = approximate_usable_pixels_radius(cam)
            ctx.bottom2_usable_radius = approximate_usable_pixels_radius(cam2)
            ctx.pole_flip180 = bool(
                np.dot(np.asarray(cam.up), np.asarray(cam2.up)) < 0
            )

    if config.enable_top or config.enable_bottom:
        # pole-to-side ramp geometry (TestRenderStereoPanorama.cpp:454-481);
        # the reference always uses the *bottom* camera's fov here, even
        # on the top path (line 461) — replicated.
        pole_cam = rig.cameras[rig.bottom_camera_index]
        pole_radius = get_fov(pole_cam)
        side_radius = rig_fov(sides, True)
        crop_radius = 0.5 * (np.pi / 2 - side_radius) + 0.5 * min(np.pi / 2, pole_radius)
        pole_radius_deg = np.degrees(pole_radius)
        phi_from_pole = np.degrees(crop_radius)
        phi_from_side = 90.0 - np.degrees(side_radius)
        phi_mid = (phi_from_pole + phi_from_side) / 2.0
        phi_diff = abs(phi_from_pole - phi_from_side)
        ctx.pole_ramp_geometry = {
            "pole_radius_deg": float(pole_radius_deg),
            "phi_ramp_start": float(phi_mid - phi_diff / 2.0),
            "phi_mid": float(phi_mid),
            "phi_ramp_end": float(phi_mid + phi_diff / 2.0),
        }
    return ctx


# Output width from which the pole warp follows the displacement with
# residual windows (the fused kernel); below it, static windows. The
# reference's threshold, so both take the same route at any size.
RESIDUAL_SAMPLER_MIN_EQR_W = 3000

# residual-window tiling of the pole composite warp (reference defaults)
_POLE_WARP_TR = 8
_POLE_WARP_TC = 128


def _project_side_cameras(ctx: RenderContext, side_images, first: int = 0):
    """Feather source rows, then remap each side camera into its spherical
    strip (projectSideToSpherical, TestRenderStereoPanorama.cpp:99-135).
    ``side_images`` are side cameras [first, first + n) of the ring."""
    with span("projection"):
        feather = ctx.config.side_alpha_feather_size
        imgs = side_images
        if feather:
            H = imgs.shape[-2]
            y = torch.arange(H, dtype=torch.float32, device=imgs.device)
            ramp_top = torch.clamp((y + 0.5) / feather, max=1.0)
            ramp_full = torch.minimum(ramp_top, ramp_top.flip(0))[None, :, None]
            alpha = imgs[:, 3] * ramp_full
            imgs = torch.cat([imgs[:, :3], alpha[:, None]], dim=1)
        n = imgs.shape[0]
        cams = None if (first, n) == (0, ctx.num_side_cams) else (first, first + n)
        plan = ctx.static_plan("side", imgs.shape[-2:], imgs.device, cams)
        return remap_static_planned(imgs, plan, site="side_projection")


def _side_pair_flows(ctx: RenderContext, overlap_l, overlap_r, state, use_temporal):
    """The 28 pair flows + their temporal state, with optional
    side_flow_scale downscaling. The state is stored at the solver's
    working resolution, in the units of that resolution (as in the
    reference)."""
    with span("side_flow"):
        cfg = ctx.config
        flow_params = make_flow_params(cfg.side_flow_alg)
        scale = cfg.side_flow_scale
        sh, ov = overlap_l.shape[-2:]
        if scale != 1.0:
            fh, fw = int(sh * scale), int(ov * scale)
            in_l = resize_area(overlap_l, (fh, fw))
            in_r = resize_area(overlap_r, (fh, fw))
        else:
            fh, fw = sh, ov
            in_l, in_r = overlap_l, overlap_r

        flow_ltr, flow_rtl = prepare_pair_flows(
            in_l, in_r, flow_params,
            prev_flow_l_to_r=state.get("pair_flow_ltr"),
            prev_flow_r_to_l=state.get("pair_flow_rtl"),
            prev_overlap_l=state.get("prev_overlap_l"),
            prev_overlap_r=state.get("prev_overlap_r"),
            use_temporal=use_temporal, site="side_flow",
        )

        dsf = flow_params.downscale_factor
        dh, dw = int(fh * dsf), int(fw * dsf)
        unit = dh / fh
        new_state = {
            "pair_flow_ltr": resize_cubic(flow_ltr, (dh, dw)) * unit,
            "pair_flow_rtl": resize_cubic(flow_rtl, (dh, dw)) * unit,
            "prev_overlap_l": resize_cubic(in_l, (dh, dw)),
            "prev_overlap_r": resize_cubic(in_r, (dh, dw)),
        }

        if scale != 1.0:
            axis_scale = torch.tensor(
                [ov / fw, sh / fh], dtype=torch.float32, device=flow_ltr.device
            ).reshape(1, 2, 1, 1)
            flow_ltr = resize_bilinear(flow_ltr, (sh, ov)) * axis_scale
            flow_rtl = resize_bilinear(flow_rtl, (sh, ov)) * axis_scale
        return flow_ltr, flow_rtl, new_state


def _render_ring_range(ctx: RenderContext, projections, next_strip, state, use_temporal):
    """Pair flows and chunk renders of the pairs whose left cameras are
    ``projections`` (n, 4, sh, sw), consecutive cameras of the ring;
    ``next_strip`` (4, sh, ov) is the first overlap of the camera after
    them (the first camera's, when they are the whole ring) and ``state``
    holds these pairs' slice of the ring state. Returns (chunks_l,
    chunks_r, ring state of these pairs)
    (TestRenderStereoPanorama.cpp:295-385)."""
    ov = ctx.overlap_w
    overlap_l = projections[..., ctx.strip_w - ov :]
    overlap_r = torch.cat([projections[1:, ..., :ov], next_strip[None]])
    flow_ltr, flow_rtl, ring_state = _side_pair_flows(
        ctx, overlap_l, overlap_r, state, use_temporal
    )
    with span("novel_view"):
        chunks_l, chunks_r = render_chunk_pair(
            overlap_l, overlap_r, flow_ltr, flow_rtl,
            ctx.warp_cols_l, ctx.t_cols, ctx.warp_cols_r,
        )
    return chunks_l, chunks_r, ring_state


def _stitch_ring(ctx: RenderContext, chunks_l, chunks_r):
    """The ring's chunks side by side, shifted to the zero-parallax
    distance: (pano_l, pano_r)."""
    with span("novel_view"):
        pano_l = stack_horizontal(list(chunks_l.unbind(0)))
        pano_r = stack_horizontal(list(chunks_r.unbind(0)))
        pano_l = offset_horizontal_wrap(pano_l, ctx.zero_parallax_shift_px)
        pano_r = offset_horizontal_wrap(pano_r, -ctx.zero_parallax_shift_px)
        return pano_l, pano_r


def _render_ring(ctx: RenderContext, projections, state, use_temporal):
    """Pair flows + chunk renders + ring concat of the whole ring."""
    chunks_l, chunks_r, ring_state = _render_ring_range(
        ctx, projections, projections[0, ..., : ctx.overlap_w], state, use_temporal
    )
    pano_l, pano_r = _stitch_ring(ctx, chunks_l, chunks_r)
    return pano_l, pano_r, ring_state


def _pad_to_height(img, target_h: int):
    """Equal (+/-1) vertical zero padding (TestRenderStereoPanorama.cpp:701-713)."""
    h = img.shape[-2]
    above = (target_h - h) // 2
    return F.pad(img, (0, 0, above, target_h - h - above))


def _prepare_fisheye_strip(ctx, name, strip_h, image, feather_size, alpha_min=False):
    """Remap a fisheye camera into its spherical strip and feather the
    bottom rows (TestRenderStereoPanorama.cpp:606-685)."""
    with span("poles.strip", pole=name):
        plan = ctx.static_plan(name, image.shape[-2:], image.device)
        spherical = remap_static_planned(image[None], plan, site="fisheye_strip")[0]
        y = torch.arange(strip_h, dtype=torch.float32, device=image.device)
        start = strip_h - 1 - feather_size
        fade = torch.clamp(1.0 - (y - start) / feather_size, 0.0, 1.0)[:, None]
        if alpha_min:
            alpha = torch.minimum(spherical[3], fade)
        else:
            alpha = fade.expand(spherical[3].shape)
        return torch.cat([spherical[:3], alpha[None]], dim=0)


def _pole_to_side_flow(ctx: RenderContext, side_pano_2, fisheye, state_key, state, use_temporal):
    """One pole's flow + composite layers for both eyes
    (poleToSideFlowThread, TestRenderStereoPanorama.cpp:388-561)."""
    fish = fisheye[None].expand((2,) + fisheye.shape)
    prev = tuple(state.get(f"{state_key}_{k}") for k in ("flow", "prev_side", "prev_fish"))
    warped, st = _pole_flow_core(ctx, side_pano_2, fish, prev, use_temporal)
    new_state = {
        f"{state_key}_flow": st[0],
        f"{state_key}_prev_side": st[1],
        f"{state_key}_prev_fish": st[2],
    }
    return warped, new_state


def _pole_flow_core(ctx: RenderContext, side_pano, fish, prev, use_temporal):
    """Batch-generic pole flow/warp: side_pano (B, 4, eqr_h, eqr_w), fish
    (B, 4, rows_f, eqr_w), prev = (flow, prev_side, prev_fish) or Nones.
    Returns (warped (B, 4, eqr_h, eqr_w), state tuple)."""
    cfg = ctx.config
    rows_f, eqr_w = fish.shape[-2:]
    B = side_pano.shape[0]
    dev = side_pano.device
    ext_w = int(eqr_w * 1.2)
    max_blend_x = int(eqr_w * 0.2)
    g = ctx.pole_ramp_geometry
    prev_flow, prev_side, prev_fish = prev

    cropped = feather_alpha(side_pano[..., :rows_f, :], cfg.std_alpha_feather_size)
    ext = lambda a: torch.cat([a, a[..., : ext_w - eqr_w]], dim=-1)
    ext_side = ext(cropped)
    ext_fish = ext(fish)

    # y-dominant pole-to-side displacement: swap the sampler's halos
    flow_params = make_flow_params(cfg.polar_flow_alg)._replace(
        window_halo_y_frac=0.30, window_halo_x_frac=0.10
    )
    hints = torch.full((B,), HINT_DOWN, dtype=torch.int32, device=dev)
    scale = cfg.polar_flow_scale
    small_side = small_fish = None
    if scale != 1.0:
        fh, fw = int(rows_f * scale), int(ext_w * scale)
        small_side = resize_area(ext_side, (fh, fw))
        small_fish = resize_area(ext_fish, (fh, fw))
        flow_small = compute_flow(
            small_side, small_fish, flow_params, hint=hints,
            prev_flow=None if prev_flow is None
            else resize_area(prev_flow, (fh, fw)) * scale,
            prev_img0=None if prev_side is None else resize_area(prev_side, (fh, fw)),
            prev_img1=None if prev_fish is None else resize_area(prev_fish, (fh, fw)),
            use_temporal=use_temporal, site="pole_flow",
        )
        flow = resize_bilinear(flow_small, (rows_f, ext_w)) / scale
    else:
        flow = compute_flow(
            ext_side, ext_fish, flow_params, hint=hints, prev_flow=prev_flow,
            prev_img0=prev_side, prev_img1=prev_fish, use_temporal=use_temporal,
            site="pole_flow",
        )

    # phi-ramped warp of the fisheye toward the sides
    # (TestRenderStereoPanorama.cpp:483-503)
    phi = g["pole_radius_deg"] * (
        (torch.arange(rows_f, dtype=torch.float32, device=dev) + 0.5) / rows_f
    )
    ramp_flow = 1.0 - ramp(phi, g["phi_ramp_start"], g["phi_mid"])
    warp_scale = (1.0 - ramp_flow)[None, :, None]
    gy = torch.arange(rows_f, dtype=torch.float32, device=dev)[:, None].expand(rows_f, ext_w)
    gx = torch.arange(ext_w, dtype=torch.float32, device=dev)[None, :].expand(rows_f, ext_w)
    halo_y = max(16, int(0.25 * rows_f))
    halo_x = max(16, int(0.02 * eqr_w))
    # only the ramp band [r0, r1) needs resampling: rows above it copy
    # through, rows below it ship zeroed rgb (their alpha is 0)
    pr_deg = g["pole_radius_deg"]
    r0 = int(np.floor(rows_f * g["phi_ramp_start"] / pr_deg - 0.5))
    r0 = max(0, min(rows_f, r0))
    r1 = int(np.ceil(rows_f * g["phi_ramp_end"] / pr_deg + 0.5)) + 1
    r1 = max(min(rows_f, r1), min(rows_f, r0 + 8))
    band = slice(r0, r1)
    disp_x = torch.clamp(warp_scale[..., band, :] * flow[:, 0, band], -halo_x, halo_x)
    disp_y = torch.clamp(warp_scale[..., band, :] * flow[:, 1, band], -halo_y, halo_y)
    # slice the source to the band's tap reach and rebase y into the slice
    pad_b = halo_y + 3
    s0 = max(0, r0 - pad_b)
    s1 = min(rows_f, r1 + pad_b)
    src_band = ext_fish[..., s0:s1, :]
    halo_y_eff = halo_y + (r0 - s0)
    gx_b, gy_b = gx[band], gy[band] - float(s0)
    if eqr_w >= RESIDUAL_SAMPLER_MIN_EQR_W:
        warped_band = sample_displaced_residual(
            src_band, gx_b[None] + disp_x, gy_b[None] + disp_y,
            halo_y=halo_y_eff, halo_x=halo_x,
            res_halo_y=max(24, rows_f // 32), res_halo_x=max(16, eqr_w // 256),
            interpolation="bicubic", border="constant",
            tr=_POLE_WARP_TR, tc=_POLE_WARP_TC, site="pole_warp",
        )
    else:
        warped_band = sample_displaced(
            src_band, gx_b[None] + disp_x, gy_b[None] + disp_y,
            halo_y=halo_y_eff, halo_x=halo_x,
            interpolation="bicubic", border="constant", tr=16, tc=128,
            max_window_elems=64 * 1024 * 1024, site="pole_warp",
        )
    warped_ext = torch.cat(
        [ext_fish[..., :r0, :], warped_band, torch.zeros_like(ext_fish[..., r1:, :])],
        dim=-2,
    )

    # fold the right extension back onto the left edge
    # (TestRenderStereoPanorama.cpp:505-524)
    main = warped_ext[..., :eqr_w]
    x = torch.arange(max_blend_x, dtype=torch.float32, device=dev)
    blend = 1.0 - ramp(x, max_blend_x * 0.333, max_blend_x * 0.667)
    wrap_strip = warped_ext[..., eqr_w : eqr_w + max_blend_x]
    left_rgb = wrap_strip[:, :3] * blend + main[..., :3, :, :max_blend_x] * (1.0 - blend)
    rgb = torch.cat([left_rgb, main[:, :3, :, max_blend_x:]], dim=-1)

    # alpha ramp for blending with the sides
    # (TestRenderStereoPanorama.cpp:526-536)
    ramp_alpha = 1.0 - ramp(phi, g["phi_mid"], g["phi_ramp_end"])
    alpha = main[:, 3] * ramp_alpha[None, :, None]
    warped = torch.cat([rgb, alpha[:, None]], dim=1)
    warped = F.pad(warped, (0, 0, 0, side_pano.shape[-2] - rows_f))
    # temporal state at flow resolution when the flow ran downscaled
    if small_side is not None:
        st = (flow_small / scale, small_side, small_fish)
    else:
        st = (flow, ext_side, ext_fish)
    return warped, st


def _poles_to_side_flow(ctx: RenderContext, pano2, top_strip, bottom_strip, state, use_temporal):
    """Both pole composites in one batch (poles x eyes = 4); matches the
    reference's sequential order up to the deghost blend's ~5e-5
    zero-alpha leak. Requires ctx.top_h == ctx.bottom_h."""
    side4 = torch.cat([pano2, torch.flip(pano2, dims=(-2, -1))])
    fish4 = torch.cat([
        top_strip[None].expand((2,) + top_strip.shape),
        bottom_strip[None].expand((2,) + bottom_strip.shape),
    ])

    def read(k):
        t, b = state.get(f"top_{k}"), state.get(f"bottom_{k}")
        if t is None or b is None:
            return None
        return torch.cat([t, b])

    prev = tuple(read(k) for k in ("flow", "prev_side", "prev_fish"))
    warped4, st = _pole_flow_core(ctx, side4, fish4, prev, use_temporal)
    pano2 = flatten_layers_deghost_prefer_base(pano2, warped4[:2])
    flipped = torch.flip(pano2, dims=(-2, -1))
    flipped = flatten_layers_deghost_prefer_base(flipped, warped4[2:])
    pano2 = torch.flip(flipped, dims=(-2, -1))
    new_state = {}
    for i, k in enumerate(("flow", "prev_side", "prev_fish")):
        new_state[f"top_{k}"] = st[i][:2]
        new_state[f"bottom_{k}"] = st[i][2:]
    return pano2, new_state


# equatorial faces have compact per-tile source footprints once their x
# coords are unwrapped across the theta seam; polar faces sweep every
# longitude near the pole, so their tiles' windows are as wide as the
# padded panorama
_CUBEMAP_EQ_FACES = ("right", "left", "back", "front")
_CUBEMAP_PO_FACES = ("top", "bottom")
_CUBEMAP_PAD_TAPS = 3  # bicubic reach


@lru_cache(maxsize=8)
def _plan_cubemap(eqr_h: int, eqr_w: int, face_w: int, face_h: int):
    """Host plan of the cubemap remap: the stacked face warps with the
    reference's wrap-x / clamp-y border (ImageWarper.cpp:137) turned into
    an all-taps-in-bounds constant-border remap of a padded panorama
    (wrap-padded in x, edge-padded in y). Equatorial faces are unwrapped
    to continuous x (a 90-degree face straddles at most one of the two
    arctan branch cuts), so their per-tile windows stay narrow. Returns
    (eq (2, 4 fh, fw), po (2, 2 fh, fw), pad_l, pad_r) with the coords
    already shifted into padded units."""
    eq_warps = []
    x_min, x_max = 0.0, float(eqr_w - 1)
    for face in _CUBEMAP_EQ_FACES:
        w = equirect_to_cubemap_warp((eqr_h, eqr_w), (face_w, face_h), face, np.pi)
        x = w[0]
        if x.max() - x.min() > eqr_w / 2:  # straddles the theta=0 seam
            x = np.where(x > eqr_w / 2, x - eqr_w, x)
        x_min = min(x_min, float(x.min()))
        x_max = max(x_max, float(x.max()))
        eq_warps.append(np.stack([x, w[1]]))
    po_warps = [
        equirect_to_cubemap_warp((eqr_h, eqr_w), (face_w, face_h), f, np.pi)
        for f in _CUBEMAP_PO_FACES
    ]
    pad_l = int(np.ceil(max(0.0, -x_min))) + _CUBEMAP_PAD_TAPS
    pad_r = int(np.ceil(max(0.0, x_max - (eqr_w - 1)))) + _CUBEMAP_PAD_TAPS
    eq = np.concatenate(eq_warps, axis=-2).astype(np.float32)
    po = np.concatenate(po_warps, axis=-2).astype(np.float32)
    for w in (eq, po):
        w[0] += pad_l
        w[1] += _CUBEMAP_PAD_TAPS  # y edge-pad shift
    return eq, po, pad_l, pad_r


def _cubemap(ctx, pano_rgb):
    """Equirect (3, eqr_h, eqr_w) -> stacked cubemap faces
    (convertSphericalToCubemapBicubicRemap, ImageWarper.cpp:95-141, and
    stackOutputCubemapFaces, CvUtil.cpp:117-138). The six faces are two
    static remaps (the four equatorial faces, the two polar ones) of one
    padded copy of the panorama, through the fused window kernel; their
    plans are built once per device and kept in ``ctx.plans``."""
    cfg = ctx.config
    eqr_h, eqr_w = pano_rgb.shape[-2:]
    fw_, fh = cfg.cubemap_width, cfg.cubemap_height
    eq, po, pad_l, pad_r = _plan_cubemap(eqr_h, eqr_w, fw_, fh)
    padded = torch.cat(
        [pano_rgb[..., eqr_w - pad_l :], pano_rgb, pano_rgb[..., :pad_r]], dim=-1
    )
    t = _CUBEMAP_PAD_TAPS
    padded = torch.cat(
        [padded[..., :1, :].expand(-1, t, -1), padded,
         padded[..., -1:, :].expand(-1, t, -1)], dim=-2,
    )
    stacks = []
    for name, warp in (("cubemap_eq", eq), ("cubemap_po", po)):
        key = (name, (eqr_h, eqr_w, fw_, fh), str(pano_rgb.device))
        with _PLANS_LOCK:
            if key not in ctx.plans:
                with span("setup.plan", name=name):
                    ctx.plans[key] = plan_static_remap(
                        warp[None], *padded.shape[-2:], "bicubic", pano_rgb.device
                    )
            plan = ctx.plans[key]
        stacks.append(remap_static_planned(padded[None], plan, site=name)[0])
    faces = {
        f: stack[..., i * fh : (i + 1) * fh, :]
        for stack, names in zip(stacks, (_CUBEMAP_EQ_FACES, _CUBEMAP_PO_FACES))
        for i, f in enumerate(names)
    }
    if cfg.cubemap_format == "video":
        row = lambda names: torch.cat([torch.flip(faces[f], dims=(-1,)) for f in names], dim=-1)
        return torch.cat(
            [row(("left", "right", "top")), row(("bottom", "back", "front"))], dim=-2
        )
    # photo: vertical stack in face order
    return torch.cat([faces[f] for f in CUBEMAP_FACE_ORDER], dim=-2)


def _merge_poles(ctx: RenderContext) -> bool:
    """Whether both pole composites run as one batch
    (:func:`_poles_to_side_flow`): both enabled, same strip geometry."""
    cfg = ctx.config
    return bool(cfg.enable_top and cfg.enable_bottom and ctx.top_h == ctx.bottom_h)


def render_frame(
    ctx: RenderContext,
    side_images: torch.Tensor,
    top_image: torch.Tensor | None = None,
    bottom_image: torch.Tensor | None = None,
    state: dict | None = None,
    use_temporal: bool = False,
    save_debug: bool = False,
):
    """Render one stereo frame (renderStereoPanorama,
    TestRenderStereoPanorama.cpp:716-972).

    side_images (N, 4, H, W) RGBA float32 in camera order; top_image /
    bottom_image (4, H, W) (with pole removal, bottom_image is the combined
    image of ``render.pole``); state: the previous frame's temporal state
    (or {}). Returns (outputs, new_state) with outputs["equirect"] the (3,
    2*h, w) RGB stereo pair stacked L over R and, with a cubemap size
    configured, outputs["cubemap"] (both eyes' face stacks, L over R).
    ``save_debug`` adds outputs["debug"], the reference's
    --save_debug_images intermediates (TestRenderStereoPanorama.cpp:177-185,
    :792-801), and takes the poles one at a time so that each pole's warped
    layer exists."""
    with span("frame", temporal=use_temporal):
        disable_tf32()
        state = state or {}

        projections = _project_side_cameras(ctx, side_images)
        pano_l, pano_r, ring_state = _render_ring(ctx, projections, state, use_temporal)
        debug = (dict(projections=projections, spherical_l=pano_l, spherical_r=pano_r)
                 if save_debug else None)
        del projections
        return _render_after_ring(ctx, pano_l, pano_r, ring_state, top_image, bottom_image,
                                  state, use_temporal, debug)


def _render_after_ring(ctx: RenderContext, pano_l, pano_r, ring_state, top_image,
                       bottom_image, state, use_temporal, debug=None):
    """The frame from its side panoramas on: poles, sharpening, cubemap and
    final resize. ``debug``, a dict when the debug images are asked for,
    receives the pole intermediates and becomes outputs["debug"]."""
    cfg = ctx.config
    save_debug = debug is not None
    new_state: dict[str, Any] = dict(ring_state)
    with span("novel_view"):
        pano2 = torch.stack([
            _pad_to_height(pano_l, cfg.eqr_height), _pad_to_height(pano_r, cfg.eqr_height)
        ])
    del pano_l, pano_r

    with span("poles"):
        top_strip = bottom_strip = None
        if cfg.enable_top:
            top_strip = _prepare_fisheye_strip(
                ctx, "top", ctx.top_h, top_image, cfg.std_alpha_feather_size
            )
            if save_debug:
                debug["top_strip"] = top_strip
        if cfg.enable_bottom:
            bottom_strip = _prepare_fisheye_strip(
                ctx, "bottom", ctx.bottom_h, bottom_image,
                cfg.std_alpha_feather_size, alpha_min=True,
            )
            if save_debug:
                debug["bottom_strip"] = bottom_strip

        if _merge_poles(ctx) and not save_debug:
            pano2, st = _poles_to_side_flow(
                ctx, pano2, top_strip, bottom_strip, state, use_temporal
            )
            new_state.update(st)
        else:
            if cfg.enable_top:
                warped, st = _pole_to_side_flow(ctx, pano2, top_strip, "top", state, use_temporal)
                new_state.update(st)
                if save_debug:
                    debug["top_warped"] = warped
                pano2 = flatten_layers_deghost_prefer_base(pano2, warped)
            if cfg.enable_bottom:
                flipped = torch.flip(pano2, dims=(-2, -1))
                warped, st = _pole_to_side_flow(
                    ctx, flipped, bottom_strip, "bottom", state, use_temporal
                )
                new_state.update(st)
                if save_debug:
                    debug["bottom_warped"] = warped
                flipped = flatten_layers_deghost_prefer_base(flipped, warped)
                pano2 = torch.flip(flipped, dims=(-2, -1))

    outputs = _finalize_outputs(ctx, pano2)
    if save_debug:
        outputs["debug"] = debug
    return outputs, new_state


def make_jitted_renderer(
    ctx: RenderContext, use_temporal: bool = False, staged: bool | None = None
):
    """f(side, top, bottom, state) -> (outputs, new_state) over
    :func:`render_frame` with ``use_temporal`` fixed: the reference's
    signature (``surround360_tpu/render/panorama.py::make_jitted_renderer``),
    so that callers written against it run unchanged. Nothing is compiled:
    the frame runs eagerly on the device of its inputs. ``staged`` selects
    an XLA compile schedule in the reference; it is accepted and has no
    effect here."""
    del staged

    def render(side, top, bottom, state):
        return render_frame(ctx, side, top, bottom, state=state,
                            use_temporal=use_temporal)

    return render


def _final_resize_shape(cfg) -> "tuple[int, int] | None":
    """(rows, cols) of the final per-eye resize, or None when the final
    size is the render size (batch_process_video.py:176-199 geometry)."""
    if not (cfg.final_eqr_width and cfg.final_eqr_height):
        return None
    shape = (cfg.final_eqr_height // 2, cfg.final_eqr_width)
    if shape == (cfg.eqr_height, cfg.eqr_width):
        return None
    return shape


def _finalize_outputs(ctx: RenderContext, pano2):
    """Sharpen, optional cubemap, optional final resize, stereo stack
    (TestRenderStereoPanorama.cpp:901-961)."""
    with span("output"):
        cfg = ctx.config
        rgb2 = pano2[:, :3]
        if cfg.sharpening > 0.0:
            rgb2 = sharpen_iir(
                rgb2, amount=1.0 + cfg.sharpening, iir_amount=0.25,
                h_boundary="wrap", v_boundary="reflect",
            )
        outputs = {}
        if cfg.cubemap_width > 0 and cfg.cubemap_height > 0:
            outputs["cubemap"] = torch.cat(
                [_cubemap(ctx, rgb2[0]), _cubemap(ctx, rgb2[1])], dim=-2
            )
        final = _final_resize_shape(cfg)
        if final is not None:
            rgb2 = resize_cubic(rgb2, final)
        outputs["equirect"] = torch.cat([rgb2[0], rgb2[1]], dim=-2)
        return outputs


def state_from_numpy(state: dict, device) -> dict:
    """Temporal state of numpy arrays (e.g. from the reference package) ->
    float32 tensors on ``device``, same keys."""
    return {
        k: torch.from_numpy(np.array(v, np.float32)).to(device)
        for k, v in state.items()
    }


def state_to_numpy(state: dict) -> dict:
    """Temporal state of tensors -> float32 numpy arrays, same keys."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


# prefix of the pole-removal prior's keys in a saved state
POLE_STATE_PREFIX = "pole:"


def state_to_blob(state: dict | None, pole_state: dict | None = None) -> dict:
    """One frame's saved state, as both packages pickle it: the ring and
    pole-flow state under its own keys and the pole-removal prior
    (``pole_flow``, ``prev_bottom``, ``prev_bottom2``) under ``pole:``
    keys, all float32 numpy arrays."""
    blob = state_to_numpy(state or {})
    blob.update({
        POLE_STATE_PREFIX + k: v for k, v in state_to_numpy(pole_state or {}).items()
    })
    return blob


def state_from_blob(blob: dict, device) -> "tuple[dict | None, dict]":
    """A saved state of either package -> (temporal state or None when the
    blob holds none, pole-removal prior with the prefix stripped), as
    tensors on ``device``."""
    n = len(POLE_STATE_PREFIX)
    pole = {k[n:]: v for k, v in blob.items() if k.startswith(POLE_STATE_PREFIX)}
    ring = {k: v for k, v in blob.items() if not k.startswith(POLE_STATE_PREFIX)}
    return (
        state_from_numpy(ring, device) if ring else None,
        state_from_numpy(pole, device),
    )
