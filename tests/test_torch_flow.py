"""compute_flow of the PyTorch port against the JAX package, every preset.

Both packages get the same numpy-seeded image pairs. The candidate
ranking takes an argmin over ~13 energies per pixel, so float32 summation
differences can flip near-ties and move a pixel's flow: the tests bound the
share of pixels whose flow differs by more than 0.1 px (1%) and the mean
field difference (0.01 px), not every value.

Over a deep pyramid those flips compound: on these synthetic pairs the
reference's own result then depends on how XLA orders its sums (jitted vs
eager, or the CPU count: 46% of pixels move at 256x320 between one core
and eight). So whole-solver tests run where that noise stays small, and
the residual and fused routes, which engage only at larger levels, are
held to the bounds on one pyramid level with identical inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surround360_tpu.flow.pixflow as JPF
from surround360_tpu.flow import compute_flow as jax_flow
from surround360_tpu.flow import make_flow_params as jax_params
from surround360_tpu_torch.flow import HINT_DOWN, compute_flow, make_flow_params
from surround360_tpu_torch.flow import pixflow as TPF
from surround360_tpu_torch.ops.remap import remap
from surround360_tpu_torch.ops.resize import gaussian_blur

SHARE_MAX = 0.01
MEAN_MAX = 0.01

PRESETS = [
    "pixflow_low", "pixflow_search_20", "pixflow_tpu", "pixflow_tpu_offsets",
    "pixflow_tpu_fast", "pixflow_tpu_bf16", "pixflow_tpu_f32",
]


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


def _compare(got, want, share_max=SHARE_MAX, mean_max=MEAN_MAX):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    dist = np.sqrt(((got - want) ** 2).sum(axis=1))
    share = float((dist > 0.1).mean())
    mean = float(np.abs(got - want).mean())
    assert share <= share_max, f"{share:.4f} of pixels differ by > 0.1 px"
    assert mean <= mean_max, f"mean field difference {mean:.4f} px"
    return share, mean


def _both(name, img0, img1, hints=None, jparams=None):
    kw_j = {} if hints is None else dict(hint=jnp.asarray(hints, jnp.int32))
    kw_t = {} if hints is None else dict(hint=torch.tensor(hints, dtype=torch.int32))
    want = jax_flow(jnp.asarray(img0), jnp.asarray(img1),
                    jparams or jax_params(name), **kw_j)
    got = compute_flow(torch.from_numpy(img0), torch.from_numpy(img1),
                       make_flow_params(name), **kw_t)
    return got, want


def test_side_pair_flow_matches():
    img0, img1 = _pair(0, 2, 48, 80, amp_x=3.0, amp_y=1.0)
    got, want = _both("pixflow_tpu", img0, img1)
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


@pytest.mark.parametrize("name", PRESETS)
def test_preset_params_match_jax(name):
    assert make_flow_params(name)._asdict() == jax_params(name)._asdict()


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unrecognized flow algorithm name"):
        make_flow_params("pixflow_medium")


def test_pixflow_low_matches():
    """RenderConfig's default preset: the 0.9 pyramid, no probes, full 5x5
    median. Looser share bound: measured 1.24% of pixels past 0.1 px
    (mean 0.0058 px), the same as the reference's own jitted-vs-eager
    difference on this pair (1.15%, mean 0.0082 px)."""
    img0, img1 = _pair(5, 2, 64, 96, amp_x=3.0, amp_y=1.0)
    got, want = _both("pixflow_low", img0, img1)
    _compare(got, want, share_max=0.02)
    assert float(np.abs(np.asarray(want)).mean()) > 0.3


def test_search_20_with_mixed_hints_matches():
    """The hinted coarse search with a different hint per batch element
    (LEFT, RIGHT, DOWN): measured share 0.09%, mean 0.0016 px."""
    img0, img1 = _pair(6, 3, 56, 80, amp_x=3.0, amp_y=2.0)
    got, want = _both("pixflow_search_20", img0, img1, hints=[1, 2, 3])
    _compare(got, want)


def test_adjust_initial_flow_matches():
    """The coarse search's chosen offsets equal the reference's, for every
    hint, on the coarsest level of the search preset's pyramid."""
    img0, img1 = _pair(6, 4, 64, 96, amp_x=3.0, amp_y=2.0)
    hints = [1, 2, 3, 4]

    def coarsest(img):
        t = TPF.resize_cubic(torch.from_numpy(img), (32, 48))
        grey, alpha = TPF._to_grey_alpha(t)
        grey = TPF.gaussian_blur(grey, TPF.PRE_BLUR_SIGMA, ksize=TPF.PRE_BLUR_KSIZE)
        return [TPF.resize_bilinear(a, (26, 39)).numpy() for a in (grey, alpha)]

    (I0, a0), (I1, a1) = coarsest(img0), coarsest(img1)
    flow = np.zeros((4, 2, 26, 39), np.float32)
    want = np.asarray(JPF._adjust_initial_flow(
        *map(jnp.asarray, (I0, I1, a0, a1, flow)), jnp.asarray(hints, jnp.int32),
        jax_params("pixflow_search_20"),
    ))
    got = TPF._adjust_initial_flow(
        *map(torch.from_numpy, (I0, I1, a0, a1, flow)),
        torch.tensor(hints, dtype=torch.int32), make_flow_params("pixflow_search_20"),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).mean() > 0.1  # the search moved pixels
    assert len({tuple(np.unique(want[b, 0])) for b in range(4)}) > 1


def test_offsets_plain_route_matches():
    """pixflow_tpu_offsets where every level is under the fused route's
    16384 px: the offset fields come from the plain route in both."""
    img0, img1 = _pair(8, 2, 48, 80, amp_x=3.0, amp_y=1.0)
    got, want = _both("pixflow_tpu_offsets", img0, img1)
    _compare(got, want)


def _level_inputs(seed):
    """A 128x160 level (the finest of a 256x320 pair) with a smooth
    incoming flow, as numpy arrays for both packages."""
    img0, img1 = _pair(seed, 1, 256, 320, amp_x=3.0, amp_y=1.5)

    def level(img):
        t = TPF.resize_cubic(torch.from_numpy(img), (128, 160))
        grey, alpha = TPF._to_grey_alpha(t)
        grey = TPF.gaussian_blur(grey, TPF.PRE_BLUR_SIGMA, ksize=TPF.PRE_BLUR_KSIZE)
        return grey.numpy(), alpha.numpy()

    (I0, a0), (I1, a1) = level(img0), level(img1)
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(128), np.arange(160), indexing="ij")
    flow = np.stack([1.5 * np.sin(2 * np.pi * gy / 128 + 0.3),
                     0.75 * np.cos(2 * np.pi * gx / 160)])[None]
    flow = (flow + 0.3 * rng.standard_normal(flow.shape)).astype(np.float32)
    return I0, I1, a0, a1, flow


def _level_both(jparams, tparams, arrays):
    want = JPF._propagation_and_search(*map(jnp.asarray, arrays), jparams, is_finest=True)
    got = TPF._propagation_and_search(*map(torch.from_numpy, arrays), tparams, is_finest=True)
    return got, np.asarray(want)


def test_fast_residual_level_matches():
    """pixflow_tpu_fast's level-rebased residual sampling, on the finest
    level of a 256x320 pair, where the reference's predicate engages it."""
    arrays = _level_inputs(7)
    pt = make_flow_params("pixflow_tpu_fast")
    H, W = arrays[0].shape[-2:]
    halo_x = max(pt.window_min_halo, int(pt.window_halo_x_frac * W))
    halo_y = max(pt.window_min_halo, int(pt.window_halo_y_frac * H))
    plan = TPF.plan_windows_budgeted(
        (H, W), (H, W), halo_y, halo_x, "bilinear", "clamp", tr=8,
        tc=pt.window_tile_cols, elems_per_px=2,
        max_window_elems=TPF.WINDOW_STACK_MAX_ELEMS,
    )
    r_halo = 2 * sum(pt.fine_prop_offsets) + 8
    residual_area = (pt.window_tile_cols + 2 * r_halo + 3) * (8 + 2 * r_halo + 3)
    assert residual_area < 0.75 * plan.bw * plan.bh and plan.ntx * plan.nty > 1
    got, want = _level_both(jax_params("pixflow_tpu_fast"), pt, arrays)
    _compare(got, want)
    plain, _ = _level_both(jax_params("pixflow_tpu"), make_flow_params("pixflow_tpu"), arrays)
    assert float((got - plain).abs().max()) > 1e-3  # the residual path ran


def _tpu_routed(orig, fused="pallas"):
    """A make_window_sampler that records its routes. For the reference
    (``fused="pallas"``) it also routes as on its TPU: the Pallas kernel
    (interpret mode here) from 16384 output pixels, unless a call forces
    "xla"; the port's "auto" already routes so (``fused=None``)."""

    @functools.wraps(orig)
    def routed(img, out_hw, *a, backend="auto", **kw):
        if fused and backend == "auto" and out_hw[0] * out_hw[1] >= 16384:
            backend = fused
        fn = orig(img, out_hw, *a, backend=backend, **kw)
        routed.backends.append(fn.backend)
        return fn

    routed.backends = []
    return routed


def test_offsets_fused_route_level_matches(monkeypatch):
    """pixflow_tpu_offsets at a 20480 px level: the port's offset sampler
    takes the fused route (K3's twin here), the reference its Pallas
    kernel. The reference runs with float32 ranking samples: its preset's
    "default" precision makes its kernel rank in bf16, which moves 40% of
    this level (ROADMAP queue C); the port ranks in float32."""
    arrays = _level_inputs(9)
    routed = _tpu_routed(JPF.make_window_sampler)
    monkeypatch.setattr(JPF, "make_window_sampler", routed)
    jax.clear_caches()
    pj = jax_params("pixflow_tpu_offsets")._replace(error_sampler_precision="float32")
    pt = make_flow_params("pixflow_tpu_offsets")
    ported = _tpu_routed(TPF.make_window_sampler, fused=None)
    monkeypatch.setattr(TPF, "make_window_sampler", ported)
    try:
        got, want = _level_both(pj, pt, arrays)
    finally:
        jax.clear_caches()
    assert "pallas" in routed.backends and "kernel" in ported.backends
    _compare(got, want)
