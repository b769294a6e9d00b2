"""compute_flow (pixflow_tpu) of the PyTorch port against the JAX package.

Both packages get the same numpy-seeded image pairs. The candidate
ranking takes an argmin over ~13 energies per pixel, so float32 summation
differences can flip near-ties and move a pixel's flow: the tests bound the
share of pixels whose flow differs by more than 0.1 px (1%) and the mean
field difference (0.01 px), not every value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.flow import compute_flow as jax_flow
from surround360_tpu.flow import make_flow_params as jax_params
from surround360_tpu_torch.flow import HINT_DOWN, compute_flow, make_flow_params
from surround360_tpu_torch.ops.remap import remap
from surround360_tpu_torch.ops.resize import gaussian_blur

SHARE_MAX = 0.01
MEAN_MAX = 0.01


def _texture(rng, B, H, W):
    noise = torch.from_numpy(rng.random((B, 3, H, W), dtype=np.float32))
    rgb = gaussian_blur(noise, 1.5)
    rgb = (rgb - rgb.amin()) / (rgb.amax() - rgb.amin())
    return torch.cat([rgb, torch.ones(B, 1, H, W)], dim=1)


def _pair(seed, B, H, W, amp_x, amp_y):
    """img1 = img0 warped by a smooth displacement field (up to amp px)."""
    rng = np.random.default_rng(seed)
    img0 = _texture(rng, B, H, W)
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
        indexing="ij",
    )
    dx = amp_x * torch.sin(2 * np.pi * gy / H + 0.3)
    dy = amp_y * torch.cos(2 * np.pi * gx / W)
    coords = torch.stack([gx - dx, gy - dy])[None].expand(B, 2, H, W)
    img1 = remap(img0, coords, "bicubic", "clamp")
    img1[:, 3] = 1.0
    return img0.numpy(), img1.numpy()


def _compare(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    dist = np.sqrt(((got - want) ** 2).sum(axis=1))
    share = float((dist > 0.1).mean())
    mean = float(np.abs(got - want).mean())
    assert share <= SHARE_MAX, f"{share:.4f} of pixels differ by > 0.1 px"
    assert mean <= MEAN_MAX, f"mean field difference {mean:.4f} px"
    return share, mean


def test_side_pair_flow_matches():
    img0, img1 = _pair(0, 2, 48, 80, amp_x=3.0, amp_y=1.0)
    want = jax_flow(jnp.asarray(img0), jnp.asarray(img1), jax_params("pixflow_tpu"))
    got = compute_flow(torch.from_numpy(img0), torch.from_numpy(img1),
                       make_flow_params("pixflow_tpu"))
    _compare(got, want)
    assert float(np.abs(np.asarray(want)).mean()) > 0.3  # a real flow


def test_pole_flow_with_hint_and_halos_matches():
    """The pole call: HINT_DOWN hints and the y-dominant halo fractions."""
    img0, img1 = _pair(1, 4, 64, 96, amp_x=1.0, amp_y=4.0)
    pj = jax_params("pixflow_tpu")._replace(window_halo_y_frac=0.30, window_halo_x_frac=0.10)
    pt = make_flow_params("pixflow_tpu")._replace(
        window_halo_y_frac=0.30, window_halo_x_frac=0.10
    )
    want = jax_flow(jnp.asarray(img0), jnp.asarray(img1), pj,
                    hint=jnp.full((4,), HINT_DOWN, jnp.int32))
    got = compute_flow(torch.from_numpy(img0), torch.from_numpy(img1), pt,
                       hint=torch.full((4,), HINT_DOWN, dtype=torch.int32))
    _compare(got, want)


def test_temporal_prior_matches():
    img0, img1 = _pair(2, 2, 40, 64, amp_x=2.0, amp_y=1.0)
    prev0, prev1 = _pair(3, 2, 40, 64, amp_x=2.5, amp_y=0.5)
    rng = np.random.default_rng(4)
    prev_flow = rng.uniform(-1, 1, (2, 2, 20, 32)).astype(np.float32)
    kw_j = dict(prev_flow=jnp.asarray(prev_flow), prev_img0=jnp.asarray(prev0),
                prev_img1=jnp.asarray(prev1), use_temporal=True)
    kw_t = dict(prev_flow=torch.from_numpy(prev_flow), prev_img0=torch.from_numpy(prev0),
                prev_img1=torch.from_numpy(prev1), use_temporal=True)
    want = jax_flow(jnp.asarray(img0), jnp.asarray(img1), jax_params("pixflow_tpu"), **kw_j)
    got = compute_flow(torch.from_numpy(img0), torch.from_numpy(img1),
                       make_flow_params("pixflow_tpu"), **kw_t)
    _compare(got, want)


def test_unported_presets_raise():
    with pytest.raises(ValueError, match="not ported"):
        make_flow_params("pixflow_low")
