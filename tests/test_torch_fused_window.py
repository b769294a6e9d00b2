"""The fused window sampler of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain twin; the JAX reference runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.

Tolerance 5e-5 max-abs: the JAX kernel evaluates its f32 contractions as
the 3-pass bf16-limb product even in interpret mode (precision.py:37,
pallas_remap.py:234-261), about 1e-5 off f32 on unit-range data; the twin
computes the same taps in plain f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.ops import pallas_remap as J
from surround360_tpu.ops import window_sampler as JW
from surround360_tpu.ops.remap import _remap_static_pallas
from surround360_tpu.ops.remap import remap as jax_remap
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops import fused_window as fw
from surround360_tpu_torch.ops import window_sampler as TW
from surround360_tpu_torch.ops.remap import remap_static_banded_multi
from surround360_tpu_torch.ops.warp import rig_fov, side_cam_spherical_warp

TOL = 5e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=a.dtype))


def _kernel_case(interp, border, tight, seed=0):
    rng = np.random.default_rng(seed)
    L, C, Hp, Wp, T, P = 2, 3, 48, 448, 4, 256
    padded = rng.random((L, C, Hp, Wp), dtype=np.float32)
    bh = 24
    if tight:
        # unaligned origins, exact width 61; the JAX kernel fetches
        # [floor128(sx), +bw), which must lie inside the array
        bw, base_bw = 256, 61
        sx = rng.integers(0, Wp - bw, (T, L)).astype(np.int32)
    else:
        bw, base_bw = 128, None  # lane-aligned origins
        sx = (rng.integers(0, 2, (T, L)) * 128).astype(np.int32)
    sy = (rng.integers(0, 3, (T, L)) * 8).astype(np.int32)
    wx = base_bw or bw
    xt = (sx[..., None] + rng.uniform(-5, wx + 5, (T, L, P))).astype(np.float32)
    yt = (sy[..., None] + rng.uniform(-5, bh + 5, (T, L, P))).astype(np.float32)
    kw = dict(bh=bh, bw=bw, pad_y=4, pad_x=6, n_y=Hp - 12, n_x=Wp - 90,
              interpolation=interp, border=border, base_bw=base_bw)
    return (padded, sy, sx, xt, yt), kw


@pytest.mark.parametrize("tight", [False, True], ids=["plain", "tight_x"])
@pytest.mark.parametrize("border", ["constant", "clamp"])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_twin_matches_jax_kernel(interp, border, tight):
    arrays, kw = _kernel_case(interp, border, tight)
    want = np.asarray(J.fused_window_sample(*map(jnp.asarray, arrays), **kw))
    got = fw.fused_window_sample(*map(_t, arrays), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


def test_twin_nan_coords_read_zero_like_jax_kernel():
    """bicubic/constant (the main path's mode): a NaN coordinate weighs
    every tap 0 in the JAX kernel's distance form, and reads 0 in the twin."""
    arrays, kw = _kernel_case("bicubic", "constant", True, seed=1)
    padded, sy, sx, xt, yt = arrays
    xt[1, 0, :5] = np.nan
    yt[2, 1, 7:9] = np.nan
    want = np.asarray(J.fused_window_sample(*map(jnp.asarray, arrays), **kw))
    got = fw.fused_window_sample(*map(_t, arrays), **kw).numpy()
    assert np.isfinite(got).all()
    assert np.all(got[1, 0, :, :5] == 0.0) and np.all(got[2, 1, :, 7:9] == 0.0)
    np.testing.assert_allclose(got, want, atol=TOL)


def _side_warps():
    rig = make_ring_rig().rescaled(0.125)
    sides = rig.side_cameras
    h_rad = 2.0 * rig_fov(sides, False)
    v_rad = 2.0 * rig_fov(sides, True)
    return np.stack([
        side_cam_spherical_warp(cam, i, len(sides), (280, 140), h_rad, v_rad)[0]
        for i, cam in enumerate(sides[:3])
    ])


def test_static_remap_matches_jax_fused_and_dense():
    """Stages 1 and 4: the port's static remap (kernel route) against the
    JAX package's fused static route (interpret mode) and its dense remap,
    on real side-camera lens warps."""
    warps = _side_warps()
    rng = np.random.default_rng(11)
    imgs = rng.uniform(0, 1, (3, 4, 128, 128)).astype(np.float32)
    got = remap_static_banded_multi(_t(imgs), warps, "bicubic", "constant").numpy()
    fused = np.asarray(
        _remap_static_pallas(jnp.asarray(imgs), warps, "bicubic", "constant", 16, 128, None)
    )
    np.testing.assert_allclose(got, fused, atol=TOL)
    for i in range(3):
        dense = np.asarray(jax_remap(jnp.asarray(imgs[i]), jnp.asarray(warps[i])))
        np.testing.assert_allclose(got[i], dense, atol=TOL)


def _residual_case():
    """The JAX package's residual-sampler fields (test_window_sampler.py
    TestResidualSampler._case): large global offsets, small local spread,
    distinct per-lead fields."""
    rng = np.random.default_rng(3)
    H, W = 160, 384
    img = rng.random((2, 4, H, W), dtype=np.float32)
    gy, gx = np.meshgrid(
        np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
        indexing="ij",
    )
    dy = 80 * np.sin(2 * np.pi * gy / H)[None] + 3 * np.sin(2 * np.pi * gx / 23)[None]
    dx = 60 * np.cos(2 * np.pi * gx / W)[None] + 2 * np.cos(2 * np.pi * gy / 31)[None]
    dy = np.repeat(dy, 2, 0)
    dx = np.repeat(dx, 2, 0)
    dy[1] *= 0.7
    dx[1] *= -0.5
    x = (gx[None] + dx).astype(np.float32)
    y = (gy[None] + dy).astype(np.float32)
    return img, x, y


@pytest.mark.parametrize(
    "interp,border,res_halo",
    [
        ("bicubic", "constant", (24, 40)),
        ("bilinear", "clamp", (24, 40)),
        # halos below the within-tile spread: the window contract decides
        ("bicubic", "constant", (6, 10)),
    ],
)
def test_residual_sampler_matches_jax_pallas_route(interp, border, res_halo):
    """Stages 3 and 5: sample_displaced_residual against the JAX Pallas
    route (quantized windows), including NaN displacement."""
    img, x, y = _residual_case()
    x[0, 40:43, 100:104] = np.nan  # NaN origin: sanitized before the clamp
    kw = dict(halo_y=96, halo_x=72, res_halo_y=res_halo[0],
              res_halo_x=res_halo[1], interpolation=interp, border=border,
              tr=8, tc=64)
    want = np.asarray(JW.sample_displaced_residual(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), **kw, backend="pallas"
    ))
    got = TW.sample_displaced_residual(_t(img), _t(x), _t(y), **kw).numpy()
    finite = np.isfinite(want)  # the JAX bilinear distance form yields NaN there
    assert finite[1].all() and finite.mean() > 0.999
    np.testing.assert_allclose(got[finite], want[finite], atol=TOL)


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_static_window_samplers_match_jax(interp):
    """sample_displaced and make_window_sampler (the flow's route): same
    static windows, same beyond-halo zeros."""
    img, x, y = _residual_case()
    H, W = img.shape[-2:]
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = (gx + 0.15 * (x - gx)).astype(np.float32)
    ys = (gy + 0.15 * (y - gy)).astype(np.float32)
    kw = dict(halo_y=6, halo_x=8, interpolation=interp, border="constant",
              tr=8, tc=32)
    want = np.asarray(JW.sample_displaced(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys), **kw))
    got = TW.sample_displaced(_t(img), _t(xs), _t(ys), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    plan = JW.plan_windows((H, W), (H, W), 10, 20, "bilinear", "clamp", 8, 16)
    ex = np.stack([xs, 0.5 * (xs + gx)]).astype(np.float32)  # candidate dim
    ey = np.stack([ys, 0.5 * (ys + gy)]).astype(np.float32)
    fj = JW.make_window_sampler(jnp.asarray(img), (H, W), 10, 20, "bilinear",
                                "clamp", xla_plan=plan, backend="xla")
    ft = TW.make_window_sampler(_t(img), (H, W), 10, 20, "bilinear", "clamp",
                                xla_plan=TW.WindowPlan(*plan), backend="xla")
    np.testing.assert_allclose(
        ft(_t(ex), _t(ey)).numpy(), np.asarray(fj(jnp.asarray(ex), jnp.asarray(ey))),
        atol=1e-5,
    )


def test_static_remap_c3_wide_windows_matches_jax():
    """The cubemap's call shape: a C = 3 source through one static warp,
    bicubic, constant border, with tiles whose samples sweep every column
    (the polar faces near the pole), so that the planned windows are as
    wide as the source. Against the JAX package's banded remap and its
    dense remap, within 5e-5."""
    from surround360_tpu.ops.remap import remap_static_banded as jax_banded
    from surround360_tpu_torch.ops.remap import plan_static_remap, remap_static_banded

    rng = np.random.default_rng(11)
    H, W, Ho, Wo = 40, 300, 48, 160
    img = rng.random((3, H, W), dtype=np.float32)
    gy, gx = np.meshgrid(np.arange(Ho, dtype=np.float32), np.arange(Wo, dtype=np.float32),
                         indexing="ij")
    x = 3.0 + gx * ((W - 7.0) / Wo) + rng.uniform(-0.5, 0.5, (Ho, Wo))
    y = 3.0 + gy * ((H - 7.0) / Ho) + rng.uniform(-0.5, 0.5, (Ho, Wo))
    x[:16] = rng.uniform(3.0, W - 4.0, (16, Wo))  # every longitude in each tile
    coords = np.stack([x, y]).astype(np.float32)
    plan = plan_static_remap(coords[None], H, W, "bicubic", "cpu")
    assert plan.bw >= W - 8 and plan.xt.shape == (3 * 2, 1, 16 * 128)
    got = remap_static_banded(_t(img), coords, "bicubic", "constant").numpy()
    assert got.shape == (3, Ho, Wo)
    dense = np.asarray(jax_remap(jnp.asarray(img), jnp.asarray(coords), "bicubic", "constant"))
    banded = np.asarray(jax_banded(jnp.asarray(img), coords, "bicubic", "constant"))
    np.testing.assert_allclose(got, dense, atol=TOL)
    np.testing.assert_allclose(got, banded, atol=TOL)
