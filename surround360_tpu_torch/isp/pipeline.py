"""The software ISP: JSON-configured raw Bayer -> color-correct RGB.

Port of ``surround360_tpu/isp/pipeline.py`` (reference:
surround360_render/source/camera_isp/CameraIsp.h, the scalar ISP, and
CameraIspGen.cpp, its Halide version). The pipeline is plain PyTorch on
the device of its input: masked elementwise ops on whole planes, two LUT
gathers and the demosaic stencil, over any leading batch dims.

Stage order matches executePipeline (CameraIsp.h:1262-1272):
black level -> anti-vignette -> white balance -> clamp/stretch -> stuck
pixel removal -> demosaic -> CCM + tone LUT -> sharpen.

Host-side precompute (config time, float64 numpy, equal to the reference
package's): tone-curve LUT (4096 x 3, CameraIsp.h:390-426), composite CCM
= ccm^T * saturation-in-YUV * lutScale (CameraIsp.h:671-689), separable
vignette gain vectors from the Bezier rolloff control points, Bayer masks.
It is made once per configuration, plane size and device and kept there
(the last :data:`TABLES_KEEP` of them; the Bayer masks once per pattern,
size and device, shared by every configuration with that pattern), so a
repeated call uploads nothing and never waits for the device. The cached
tensors are inputs only: nothing here writes them.

Values are float32 in [0,1] end-to-end (the reference's outputBpp scaling
collapses to 1.0).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops.filters import iir_lowpass_2d
from ..utils.math_util import bezier_curve, disable_tf32
from ..utils.tracing import count, span
from .demosaic import (
    _Reflected,
    demosaic_bilinear,
    demosaic_edge_aware,
    demosaic_frequency,
)

__all__ = [
    "IspConfig",
    "load_isp_config",
    "isp_process",
    "apply_companding",
    "resize_input_binned",
    "build_tone_curve_lut",
    "build_composite_ccm",
    "build_vignette_gains",
    "bayer_masks",
]

TONE_CURVE_LUT_SIZE = 4096

RGB2YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14713, -0.28886, 0.436],
        [0.615, -0.51499, -0.10001],
    ],
    dtype=np.float64,
)
YUV2RGB = np.array(
    [
        [1.0, 0.0, 1.13983],
        [1.0, -0.39465, -0.58060],
        [1.0, 2.03211, 0.0],
    ],
    dtype=np.float64,
)

_BAYER_TABLES = {
    # pattern -> (red[2][2], green[2][2]) (CameraIsp.h setup :612-668)
    "RGGB": ([[1, 0], [0, 0]], [[0, 1], [1, 0]]),
    "GRBG": ([[0, 1], [0, 0]], [[1, 0], [0, 1]]),
    "GBRG": ([[0, 0], [1, 0]], [[1, 0], [0, 1]]),
    "BGGR": ([[0, 0], [0, 1]], [[0, 1], [1, 0]]),
}


@dataclass(frozen=True)
class IspConfig:
    """Parsed "CameraIsp" JSON block with reference defaults
    (CameraIsp.h:441-610)."""

    bits_per_pixel: int = 8
    companding_lut: tuple = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    black_level: tuple = (0.0, 0.0, 0.0)
    clamp_min: tuple = (0.0, 0.0, 0.0)
    clamp_max: tuple = (1.0, 1.0, 1.0)
    stuck_pixel_threshold: int = 0
    stuck_pixel_darkness_threshold: float = 0.0
    stuck_pixel_radius: int = 0
    vignette_rolloff_h: tuple = ((1.0, 1.0, 1.0),)
    vignette_rolloff_v: tuple = ((1.0, 1.0, 1.0),)
    white_balance_gain: tuple = (1.0, 1.0, 1.0)
    ccm: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    saturation: float = 1.0
    gamma: tuple = (1.0, 1.0, 1.0)
    low_key_boost: tuple = (0.0, 0.0, 0.0)
    high_key_boost: tuple = (0.0, 0.0, 0.0)
    contrast: float = 1.0
    sharpening: tuple = (0.0, 0.0, 0.0)
    sharpening_support: float = 10.0 / 2048.0
    noise_core: float = 1000.0
    bayer_pattern: str = "GBRG"
    demosaic_filter: str = "edge_aware"  # bilinear | frequency | edge_aware
    disable_tone_curve: bool = False

    @property
    def max_pixel_value(self) -> int:
        return (1 << self.bits_per_pixel) - 1

    def to_json(self) -> dict:
        """Emit the reference's config schema (dumpConfigFile,
        CameraIsp.h:717-829)."""
        return {
            "CameraIsp": {
                "bitsPerPixel": self.bits_per_pixel,
                "compandingLut": [list(p) for p in self.companding_lut],
                "blackLevel": list(self.black_level),
                "clampMin": list(self.clamp_min),
                "clampMax": list(self.clamp_max),
                "stuckPixelThreshold": self.stuck_pixel_threshold,
                "stuckPixelDarknessThreshold": self.stuck_pixel_darkness_threshold,
                "stuckPixelRadius": self.stuck_pixel_radius,
                "vignetteRollOffH": [list(p) for p in self.vignette_rolloff_h],
                "vignetteRollOffV": [list(p) for p in self.vignette_rolloff_v],
                "whiteBalanceGain": list(self.white_balance_gain),
                "ccm": [list(r) for r in self.ccm],
                "saturation": self.saturation,
                "gamma": list(self.gamma),
                "lowKeyBoost": list(self.low_key_boost),
                "highKeyBoost": list(self.high_key_boost),
                "contrast": self.contrast,
                "sharpening": list(self.sharpening),
                "sharpeningSupport": self.sharpening_support,
                "noiseCore": self.noise_core,
                "bayerPattern": self.bayer_pattern,
            }
        }


def load_isp_config(source) -> IspConfig:
    """Parse an ISP JSON (file path, JSON string, or dict)."""
    if isinstance(source, dict):
        obj = source
    elif isinstance(source, str) and source.lstrip().startswith("{"):
        obj = json.loads(source)
    else:
        with open(source) as f:
            obj = json.load(f)
    c = obj.get("CameraIsp", {})

    def tup(key, default):
        return tuple(c.get(key, default))

    def coords(key, default):
        v = c.get(key)
        if v is None:
            return default
        return tuple(tuple(p) for p in v)

    return IspConfig(
        bits_per_pixel=int(c.get("bitsPerPixel", 8)),
        companding_lut=coords(
            "compandingLut", ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
        ),
        black_level=tup("blackLevel", (0.0, 0.0, 0.0)),
        clamp_min=tup("clampMin", (0.0, 0.0, 0.0)),
        clamp_max=tup("clampMax", (1.0, 1.0, 1.0)),
        stuck_pixel_threshold=int(c.get("stuckPixelThreshold", 0)),
        stuck_pixel_darkness_threshold=float(
            c.get("stuckPixelDarknessThreshold", 0.0)
        ),
        # the reference doubles the radius at parse time (CameraIsp.h:517)
        stuck_pixel_radius=2 * int(c.get("stuckPixelRadius", 0)),
        vignette_rolloff_h=coords("vignetteRollOffH", ((1.0, 1.0, 1.0),)),
        vignette_rolloff_v=coords("vignetteRollOffV", ((1.0, 1.0, 1.0),)),
        white_balance_gain=tup("whiteBalanceGain", (1.0, 1.0, 1.0)),
        ccm=coords(
            "ccm", ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
        ),
        saturation=float(c.get("saturation", 1.0)),
        gamma=tup("gamma", (1.0, 1.0, 1.0)),
        low_key_boost=tup("lowKeyBoost", (0.0, 0.0, 0.0)),
        high_key_boost=tup("highKeyBoost", (0.0, 0.0, 0.0)),
        contrast=float(c.get("contrast", 1.0)),
        sharpening=tup("sharpening", (0.0, 0.0, 0.0)),
        sharpening_support=float(c.get("sharpeningSupport", 10.0 / 2048.0)),
        noise_core=float(c.get("noiseCore", 1000.0)),
        bayer_pattern=str(c.get("bayerPattern", "GBRG")).upper()[:4],
    )


# ---------------------------------------------------------------------------
# host precompute
# ---------------------------------------------------------------------------


def _bezier4(a, b, c, d, t):
    return bezier_curve([a, b, c, d], t)


def _low_key(boost, x):
    a, b, c, d = 0.0, np.clip(0.1666 + boost, 0.0, 1.0), 0.3333, 0.5
    return np.where(x <= 0.5, _bezier4(a, b, c, d, x * 2.0), 0.0)


def _high_key(boost, x):
    a, b, c, d = 0.5, 0.6666, np.clip(0.8333 + boost, 0.0, 1.0), 1.0
    return np.where(x > 0.5, _bezier4(a, b, c, d, (x - 0.5) * 2.0), 0.0)


def build_tone_curve_lut(cfg: IspConfig) -> np.ndarray:
    """(4096, 3) float32 LUT in [0, 1] (buildToneCurveLut,
    CameraIsp.h:390-426 with range normalized to 1)."""
    x = np.linspace(0.0, 1.0, TONE_CURVE_LUT_SIZE)
    if cfg.disable_tone_curve:
        return np.repeat(x[:, None], 3, axis=1).astype(np.float32)
    angle = np.pi * 0.25 * cfg.contrast
    slope = np.tan(angle)
    bias = 0.5 * (1.0 - slope)
    out = []
    for ch in range(3):
        v = np.power(x, cfg.gamma[ch])
        v = _low_key(cfg.low_key_boost[ch], v) + _high_key(
            cfg.high_key_boost[ch], v
        )
        v = np.clip(slope * v + bias, 0.0, 1.0)
        out.append(v)
    return np.stack(out, axis=1).astype(np.float32)


def build_composite_ccm(cfg: IspConfig) -> np.ndarray:
    """(3, 3) composite CCM: ccm^T x saturation-in-YUV, scaled to LUT index
    range (CameraIsp.h:671-689)."""
    sat = np.diag([1.0, cfg.saturation, cfg.saturation])
    sat_rgb = YUV2RGB @ sat @ RGB2YUV
    composite = np.asarray(cfg.ccm, dtype=np.float64).T @ sat_rgb
    return (composite * (TONE_CURVE_LUT_SIZE - 1)).astype(np.float32)


def build_vignette_gains(cfg: IspConfig, height: int, width: int):
    """Separable vignette gain vectors: (W, 3) horizontal and (H, 3)
    vertical, Bezier curves sampled at coord / maxDimension
    (CameraIsp.h:851-858, antiVignette :1145-1154)."""
    max_dim = max(height, width)

    def sample(points, n):
        t = np.arange(n, dtype=np.float64) / max_dim
        pts = [np.asarray(p, dtype=np.float64) for p in points]
        if len(pts) == 1:
            return np.tile(pts[0], (n, 1)).astype(np.float32)
        vals = bezier_curve([p[None, :] for p in pts], t[:, None])
        return vals.astype(np.float32)

    return sample(cfg.vignette_rolloff_h, width), sample(
        cfg.vignette_rolloff_v, height
    )


def bayer_masks(cfg: IspConfig, height: int, width: int):
    """(H, W) bool red/green/blue masks + (H, 1) red-green-row mask."""
    return _pattern_masks(cfg.bayer_pattern, height, width)


def _pattern_masks(pattern: str, height: int, width: int):
    red_t, green_t = _BAYER_TABLES[pattern]
    ii = np.arange(height) % 2
    jj = np.arange(width) % 2
    red = np.asarray(red_t, bool)[np.ix_(ii, jj)]
    green = np.asarray(green_t, bool)[np.ix_(ii, jj)]
    blue = ~(red | green)
    red_green_row = (red[:, 0] & green[:, 1]) | (red[:, 1] & green[:, 0])
    return red, green, blue, red_green_row[:, None]


# ---------------------------------------------------------------------------
# pipeline stages (on the device of ``raw``)
# ---------------------------------------------------------------------------


def _per_site_value(vals3, red_mask, green_mask):
    """Select the per-channel value (a scalar or a plane) for each Bayer
    site."""
    r, g, b = vals3
    return torch.where(red_mask, r, torch.where(green_mask, g, b))


def apply_companding(raw: torch.Tensor, cfg: IspConfig) -> torch.Tensor:
    """Linearize a companded sensor response with the piecewise-linear
    compandingLut (linearize(), CameraIsp.h:991-1002 via the Linear
    MonotonicTable). executePipeline does not invoke it; exposed for
    sensors that need it. As in the reference package, the first (x, y)
    channel of each control point applies to all sites; values beyond the
    table's ends take its end values."""
    pts = np.asarray(cfg.companding_lut, dtype=np.float64)
    xs = torch.tensor(pts[:, 0], dtype=torch.float32, device=raw.device)
    ys = torch.tensor(pts[:, 1], dtype=torch.float32, device=raw.device)
    x = raw.float()
    i = torch.searchsorted(xs, x.contiguous(), right=True).clamp(1, xs.numel() - 1)
    df = ys[i] - ys[i - 1]
    dx = xs[i] - xs[i - 1]
    delta = x - xs[i - 1]
    f = torch.where(dx == 0, ys[i], ys[i - 1] + (delta / dx) * df)
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def _stuck_pixel_removal(raw: torch.Tensor, cfg: IspConfig) -> torch.Tensor:
    """Dense form of removeStuckPixels (CameraIsp.h:1024-1103): within the
    same-colour lattice neighbourhood (radius in raw pixels, colour step
    2), a pixel in a dark region whose rank is within the top
    ``stuckPixelThreshold`` is replaced by the neighbourhood median (the
    mean of the two middle values where their count is even, which an odd
    radius gives)."""
    rad = cfg.stuck_pixel_radius
    if rad <= 0:
        return raw
    p = _Reflected(raw, rad)
    steps = range(-rad, rad + 1, 2)
    stack = torch.stack([p.shift(dy, dx) for dy in steps for dx in steps])
    n = stack.shape[0]
    mean = stack.mean(dim=0)
    ordered = stack.sort(dim=0).values
    median = (ordered[(n - 1) // 2] + ordered[n // 2]) / 2.0 if n % 2 == 0 \
        else ordered[n // 2]
    rank_from_top = (stack > raw[None]).sum(dim=0)
    dark = mean < cfg.stuck_pixel_darkness_threshold
    stuck = dark & (rank_from_top < cfg.stuck_pixel_threshold)
    return torch.where(stuck, median, raw)


def resize_input_binned(raw: torch.Tensor, factor: int) -> torch.Tensor:
    """Bayer-phase-preserving box binning by 1/2/4/8 (resizeInput,
    CameraIsp.h:339-358): each output site averages factor^2 same-colour
    sites on the stride-2 colour lattice."""
    if factor == 1:
        return raw
    if factor not in (2, 4, 8):
        raise ValueError(f"resize must be 1, 2, 4 or 8, got {factor}")
    H, W = raw.shape[-2:]
    oh, ow = H // factor, W // factor
    ii = np.arange(oh)
    jj = np.arange(ow)
    index = lambda a: torch.from_numpy(a.astype(np.int64)).to(raw.device)
    acc = None
    for k in range(factor):
        ipp = ii * factor + k * 2 + (ii % 2)
        ipp = np.where(ipp >= H, 2 * H - 1 - ipp, ipp)
        rows = raw.index_select(-2, index(ipp))
        for l in range(factor):
            jpp = jj * factor + l * 2 + (jj % 2)
            jpp = np.where(jpp >= W, 2 * W - 1 - jpp, jpp)
            s = rows.index_select(-1, index(jpp))
            acc = s if acc is None else acc + s
    return acc / (factor * factor)


_DEMOSAIC = {
    "bilinear": demosaic_bilinear,
    "edge_aware": demosaic_edge_aware,
    "frequency": demosaic_frequency,
}


@lru_cache(maxsize=32)
def _color_tables(cfg: IspConfig):
    """(composite CCM (3, 3), tone LUT (4096, 3)) on the host."""
    return build_composite_ccm(cfg), build_tone_curve_lut(cfg)


# ---------------------------------------------------------------------------
# the tables on the device, once per configuration, size and device
# ---------------------------------------------------------------------------

TABLES_KEEP = 64  # (configuration, size, device) entries: a 17-camera rig at two sizes


class _Tables(NamedTuple):
    """One configuration's tables at one plane size on one device."""

    masks: tuple  # red, green, blue (H, W) and red-green-row (H, 1) bool
    vh: torch.Tensor  # (W, 3) horizontal vignette gains
    vv: torch.Tensor  # (H, 3) vertical vignette gains
    ccm: np.ndarray  # (3, 3) composite CCM, host
    lut: torch.Tensor  # (4096, 3) tone LUT
    amount: torch.Tensor  # (3, 1, 1) 1 + sharpening
    black: tuple  # per channel, 0-d float32: black level / max pixel value
    scale: tuple  # 1 / (1 - black)
    gain: tuple  # white balance
    cmin: tuple  # clamp min
    cmax: tuple  # clamp max


_TABLES: OrderedDict = OrderedDict()  # (cfg, H, W, device) -> _Tables, last used last
_TABLES_LOCK = threading.Lock()


@lru_cache(maxsize=TABLES_KEEP)
def _device_masks(pattern: str, height: int, width: int, device: torch.device):
    """:func:`bayer_masks` of ``pattern`` on ``device``."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in _pattern_masks(pattern, height, width))


def _make_tables(cfg: IspConfig, height: int, width: int, device: torch.device):
    def scalars(vals3):
        return tuple(torch.tensor(float(np.float32(v)), dtype=torch.float32, device=device)
                     for v in vals3)

    vh, vv = build_vignette_gains(cfg, height, width)
    ccm, lut = _color_tables(cfg)
    # black level (CameraIsp.h:1106-1126)
    bl = np.asarray(cfg.black_level, np.float32) / cfg.max_pixel_value
    return _Tables(
        masks=_device_masks(cfg.bayer_pattern, height, width, device),
        vh=torch.from_numpy(vh).to(device),
        vv=torch.from_numpy(vv).to(device),
        ccm=ccm,
        lut=torch.from_numpy(lut).to(device),
        amount=1.0 + torch.tensor(
            cfg.sharpening, dtype=torch.float32, device=device)[:, None, None],
        black=scalars(bl),
        scale=scalars(1.0 / (1.0 - bl)),
        gain=scalars(cfg.white_balance_gain),
        cmin=scalars(cfg.clamp_min),
        cmax=scalars(cfg.clamp_max),
    )


def _tables(cfg: IspConfig, height: int, width: int, device: torch.device) -> _Tables:
    """The cached :class:`_Tables` of the key, made on a miss; counts
    ``isp.tables.hit`` or ``isp.tables.miss`` into the open span."""
    key = (cfg, height, width, device)
    with _TABLES_LOCK:
        t = _TABLES.get(key)
        if t is not None:
            _TABLES.move_to_end(key)
    if t is not None:
        count("isp.tables.hit")
        return t
    count("isp.tables.miss")
    t = _make_tables(cfg, height, width, device)
    with _TABLES_LOCK:
        _TABLES[key] = t
        while len(_TABLES) > TABLES_KEEP:
            _TABLES.popitem(last=False)
    return t


def isp_process(
    raw: torch.Tensor,
    cfg: IspConfig,
    skip_sharpen: bool = False,
    skip_tone_curve: bool = False,
    resize: int = 1,
) -> torch.Tensor:
    """Run the ISP on raw mosaiced data, on the device of ``raw``.

    raw: (..., H, W) float32 tensor in [0, 1] (normalized by max pixel
    value), any leading batch dims. resize: 1/2/4/8 Bayer-preserving input
    binning (CameraIsp.h:339-358). Returns (..., 3, H, W) float32 RGB in
    [0, 1]. TF32 is turned off (the frequency demosaic and the sharpen
    filter are float32 matrix products). The host precompute and its
    uploads are made once per configuration, plane size and device and
    kept on the device, so a repeated call copies nothing to the device
    and does not synchronise. Traced as a span ``isp`` holding
    ``isp.tables`` (the cache lookup, counting ``isp.tables.hit`` or
    ``isp.tables.miss``), then the steps ``isp.correct``, ``isp.stuck``,
    ``isp.demosaic``, ``isp.color`` and ``isp.sharpen``."""
    if not isinstance(raw, torch.Tensor):
        raise TypeError("isp_process takes a torch.Tensor (it runs on its device)")
    if cfg.demosaic_filter not in _DEMOSAIC:
        raise ValueError(f"unknown demosaic filter: {cfg.demosaic_filter}")
    disable_tf32()
    dev = raw.device
    with span("isp"):
        x = resize_input_binned(raw.float(), resize)
        H, W = x.shape[-2:]
        sharpen = not skip_sharpen and all(s != 0.0 for s in cfg.sharpening)
        with span("isp.tables"):
            t = _tables(cfg, H, W, dev)
        red_mask, green_mask, blue_mask, red_green_row = t.masks
        lut = None if skip_tone_curve else t.lut

        with span("isp.correct"):
            # black level (CameraIsp.h:1106-1126): only pixels < 1.0 adjusted
            site_b = _per_site_value(t.black, red_mask, green_mask)
            site_s = _per_site_value(t.scale, red_mask, green_mask)
            x = torch.where(x < 1.0, (x - site_b) * site_s, x)

            # anti-vignette (CameraIsp.h:1145-1154): separable per-channel
            # gain outer products, then per-site channel select
            gains = [t.vv[:, c, None] * t.vh[None, :, c] for c in range(3)]
            x = x * _per_site_value(gains, red_mask, green_mask)

            # white balance + clamp (CameraIsp.h:1005-1021)
            x = torch.clamp(x * _per_site_value(t.gain, red_mask, green_mask), 0.0, 1.0)

            # clamp & stretch (CameraIsp.h:1128-1143)
            cmin = _per_site_value(t.cmin, red_mask, green_mask)
            cmax = _per_site_value(t.cmax, red_mask, green_mask)
            x = (torch.minimum(torch.maximum(x, cmin), cmax) - cmin) / (cmax - cmin)

        with span("isp.stuck"):
            x = _stuck_pixel_removal(x, cfg)
        with span("isp.demosaic"):
            rgb = _DEMOSAIC[cfg.demosaic_filter](
                x, red_mask, green_mask, blue_mask, red_green_row)
        del x

        # CCM + tone LUT (colorCorrect, CameraIsp.h:1214-1242); the LUT index
        # truncates
        with span("isp.color"):
            r, g, b = rgb.unbind(dim=-3)
            idx = torch.stack(
                [float(row[0]) * r + float(row[1]) * g + float(row[2]) * b for row in t.ccm],
                dim=-3,
            ).clamp(0.0, TONE_CURVE_LUT_SIZE - 1).to(torch.int32)
            del rgb, r, g, b
            if lut is None:
                out = idx.to(torch.float32) / (TONE_CURVE_LUT_SIZE - 1)
            else:
                out = torch.stack(
                    [lut[:, c][idx.select(-3, c).long()] for c in range(3)], dim=-3
                )

        # sharpen (CameraIsp.h:1244-1258)
        if sharpen:
            with span("isp.sharpen"):
                lp = iir_lowpass_2d(out, cfg.sharpening_support)
                hp = out - lp
                ng = 1.0 - torch.exp(-(hp * hp) * cfg.noise_core * 65025.0)
                out = torch.clamp(lp + hp * ng * t.amount, 0.0, 1.0)
        return out
