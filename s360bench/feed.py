"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed -> the frames of one video stream, made on the device.

Every seed gets the same sizes and the same amount of work: the pool's
frame count, the scene's distance and the rig come from the files; the
seed draws only the scene's phases, its start rotation and each frame's
small turn, the sensor noise, and each camera's white balance and
vignette in ``raw`` footage.

Inputs, by the mix's ``input``:

- ``rgb8``: the cameras' frames as the video CLI gets them after PNG
  decode, 8-bit RGB, held on the device as a pool of distinct frames;
- ``raw12``: the same views as a 12-bit GBRG sensor behind each camera's
  ISP would record them (the ISP's stages backwards, a copy of
  ``chip_smoke.py::_sensor_raw12``, plus read noise), held in pinned host
  memory as the footage reader returns them: (H, W) uint16, the 12-bit
  value v stored as v << 4 | v >> 8.

Frame k of the stream is pool frame :meth:`Feed.index` (k), which walks
the pool forth and back, so consecutive frames always differ and the
scene turns by a small step between them.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from . import scene
from .reference import isp as ref_isp
from .reference.system import tuples

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load_traffic(name: str) -> dict:
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as f:
        return json.load(f)


def isp_configs(config: dict, seed: int, count: int) -> list:
    """One ISP config (keyword dict of ``IspConfig``) per camera: the
    configuration's ``isp`` with white balance and vignette rolloff drawn
    per camera from the seed, within ``isp_per_camera``'s spreads."""
    rng = np.random.default_rng([seed, 1])
    spread = config["isp_per_camera"]
    out = []
    for _ in range(count):
        kw = {k: tuples(v) for k, v in config["isp"].items()}
        wb = np.asarray(kw["white_balance_gain"]) * (
            1.0 + spread["white_balance"] * rng.uniform(-1.0, 1.0, 3))
        kw["white_balance_gain"] = tuple(float(v) for v in wb)
        for key in ("vignette_rolloff_h", "vignette_rolloff_v"):
            pts = np.asarray(kw[key])
            pts = pts + spread["vignette"] * rng.uniform(-1.0, 1.0, (pts.shape[0], 1))
            kw[key] = tuple(tuple(float(v) for v in row) for row in pts)
        out.append(kw)
    return out


def sensor_raw12(view: torch.Tensor, cfg, noise: torch.Tensor | None) -> torch.Tensor:
    """What a sensor behind ``cfg``'s ISP (a reference ``IspConfig``) would
    have recorded of ``view`` (3, H, W): the tone curve as its gamma alone,
    the composite CCM, white balance, vignette and black level undone,
    mosaiced, plus ``noise`` (H, W) in 12-bit steps, as 12-bit values
    (H, W) int32."""
    dev = view.device
    H, W = view.shape[-2:]
    f64 = dict(dtype=torch.float64, device=dev)
    lin = torch.stack([view[c].double() ** (1.0 / cfg.gamma[c]) for c in range(3)])
    m = ref_isp.build_composite_ccm(cfg).astype(np.float64) / (ref_isp.TONE_CURVE_LUT_SIZE - 1)
    sensor = torch.einsum("ij,jhw->ihw", torch.as_tensor(np.linalg.inv(m), **f64), lin)
    vh, vv = (torch.as_tensor(v, **f64) for v in ref_isp.build_vignette_gains(cfg, H, W))
    red, green, _, _ = (torch.as_tensor(m_, device=dev) for m_ in ref_isp.bayer_masks(cfg, H, W))
    planes = []
    for c in range(3):
        gain = cfg.white_balance_gain[c] * vv[:, c, None] * vh[None, :, c]
        bl = cfg.black_level[c] / cfg.max_pixel_value
        planes.append(torch.clamp(sensor[c] / gain, 0.0, 1.0) * (1.0 - bl) + bl)
    mosaic = torch.where(red, planes[0], torch.where(green, planes[1], planes[2])) * 4095.0
    if noise is not None:
        mosaic = mosaic + noise
    return torch.clamp(mosaic + 0.5, 0, 4095).to(torch.int32)


def to_uint16(v12: torch.Tensor) -> torch.Tensor:
    """12-bit values -> the footage reader's uint16 (v << 4 | v >> 8)."""
    return ((v12 << 4) | (v12 >> 8)).to(torch.uint16)


def to_rgba(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) float32 in [0, 1] -> (..., 4, H, W) with alpha 1, as
    the CLI maps an RGB image."""
    alpha = torch.ones_like(rgb[..., :1, :, :])
    return torch.cat([rgb, alpha], dim=-3)


def quantize8(x: torch.Tensor) -> torch.Tensor:
    """Float [0, 1] -> uint8 as the CLI writes an 8-bit image:
    clip(x * 255 + 0.5, 0, 255), truncated."""
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


class Feed:
    """The cell's inputs: a pool of distinct frames of the seed's scene.

    ``rig`` is a camera-model rig (the reference's), ``config`` the
    configuration's dict, ``traffic`` the mix's parameters."""

    def __init__(self, config: dict, traffic: dict, seed: int, rig, device):
        self.kind = traffic["input"]
        if self.kind not in ("rgb8", "raw12"):
            raise ValueError(f"unknown input kind: {self.kind}")
        self.device = torch.device(device)
        self.pool_frames = int(traffic["pool_frames"])
        rng = np.random.default_rng([seed, 0])
        phases = rng.uniform(0.0, 2.0 * math.pi, 6)
        yaw0 = rng.uniform(0.0, 2.0 * math.pi)
        step = math.radians(traffic["turn_deg_per_frame"])
        jitter = math.radians(traffic["turn_jitter_deg"])
        self.rotations = [
            scene.rotation(yaw0 + k * step + rng.normal(0.0, jitter),
                           rng.normal(0.0, jitter), rng.normal(0.0, jitter))
            for k in range(self.pool_frames)
        ]
        self.cameras = len(rig.cameras)
        self.isp = isp_configs(config, seed, self.cameras) if self.kind == "raw12" else None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (2**63))
        W, H = (int(v) for v in np.asarray(rig.cameras[0].resolution))
        P, N = self.pool_frames, self.cameras
        if self.kind == "rgb8":
            self.pool = torch.empty((P, N, 3, H, W), dtype=torch.uint8, device=self.device)
        else:
            pin = self.device.type == "cuda"
            self.pool = torch.empty((P, N, H, W), dtype=torch.uint16, pin_memory=pin)
            isp_cfgs = [ref_isp.IspConfig(**kw) for kw in self.isp]
        sigma = float(traffic.get("read_noise_dn", 0.0))
        for i, cam in enumerate(rig.cameras):
            rays = scene.camera_rays(cam, self.device)
            for k in range(P):
                view = scene.render_view(cam, rays, traffic["scene_distance_cm"], phases,
                                         self.rotations[k], traffic["sharpness"])
                if self.kind == "rgb8":
                    self.pool[k, i] = quantize8(view)
                else:
                    noise = sigma * torch.randn((H, W), generator=gen, device=self.device,
                                                dtype=torch.float64)
                    self.pool[k, i].copy_(to_uint16(sensor_raw12(view, isp_cfgs[i], noise)))
            del rays

    def index(self, k: int) -> int:
        """Pool frame of stream frame k: 0, 1, ..., P-1, P-2, ..., 1, 0, ..."""
        period = 2 * self.pool_frames - 2
        j = k % period
        return j if j < self.pool_frames else period - j
