"""Glue: write a DNG using an ISP config's color metadata (port of
``surround360_tpu/cli/dng_helper.py``)."""

from __future__ import annotations

import numpy as np

from ..isp.dng import write_dng
from ..isp.pipeline import IspConfig


def save_isp_dng(path: str, raw, cfg: IspConfig) -> None:
    """``raw`` (H, W): a uint16 mosaic as it is, any other dtype rescaled
    so that its maximum becomes 65535."""
    raw = np.asarray(raw)
    if raw.dtype != np.uint16:
        raw = (raw.astype(np.float64) * 65535.0 / raw.max()).astype(np.uint16)
    write_dng(
        path,
        raw,
        bayer_pattern=cfg.bayer_pattern,
        ccm=np.asarray(cfg.ccm),
        white_balance=cfg.white_balance_gain,
        black_level=int(np.mean(cfg.black_level)),
        white_level=65535,
    )
