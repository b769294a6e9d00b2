"""make_window_sampler of the PyTorch port against the JAX package.

The port's fused route (on the CPU: the twin of the lead-folded kernels K2
and K3) against the reference's Pallas route, which runs in interpret
mode on the CPU as the JAX package's own tests run it. Coordinates reach
up to three halos past each output pixel, so the windows (their origins,
the widened and aligned extents, the offset margins) decide many values.

Tolerance 5e-5 max-abs: the reference's f32 samplers evaluate their
contractions as the 3-pass bf16-limb product even in interpret mode
(precision.py:37), about 1e-5 off f32; the twin computes in plain f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.ops.window_sampler import make_window_sampler as jax_sampler
from surround360_tpu_torch.ops.window_sampler import fused_route_plan, make_window_sampler

TOL = 5e-5


def _offsets(d, probes=True):
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))
    if probes:
        dirs += ((1, 1), (1, -1), (-1, 1), (-1, -1))
    return ((0, 0),) + tuple((py * d, px * d) for py, px in dirs)


def _case(H, W, B, hy, hx, K, seed, far=3.0):
    rng = np.random.default_rng(seed)
    img = rng.random((B, 2, H, W), dtype=np.float32)
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    shape = (K, B, H, W) if K else (B, H, W)
    xs = gx + (rng.random(shape) * 2 - 1) * hx * far
    ys = gy + (rng.random(shape) * 2 - 1) * hy * far
    xs = np.clip(xs, -3, W + 2).astype(np.float32)
    ys = np.clip(ys, -3, H + 2).astype(np.float32)
    return img, xs, ys


CASES = {
    # name: (H, W, B, halo_y, halo_x, K candidates, tc, border, offsets)
    "candidate_fold_E13": (72, 160, 3, 10, 14, 13, 128, "clamp", None),
    "odd_P_Wo_under_128": (64, 72, 2, 8, 8, 0, 128, "clamp", None),
    "tight_x_K2": (72, 160, 3, 10, 14, 13, 16, "clamp", None),
    "tight_x_K2_constant": (72, 160, 2, 10, 14, 4, 16, "constant", None),
    "offsets_one_x_tile": (40, 100, 3, 10, 14, 0, 128, "clamp", _offsets(8)),
    "offsets_ntx_gt_1": (72, 288, 3, 10, 14, 0, 128, "clamp", _offsets(2)),
    "offsets_constant": (72, 288, 2, 10, 14, 0, 128, "constant", _offsets(4, False)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_route_matches_jax_pallas(name):
    H, W, B, hy, hx, K, tc, border, offs = CASES[name]
    img, xs, ys = _case(H, W, B, hy, hx, K, seed=len(name))
    kw = dict(tr=8, tc=tc, precision="float32", offsets=offs)
    fj = jax_sampler(jnp.asarray(img), (H, W), hy, hx, "bilinear", border,
                     backend="pallas", **kw)
    ft = make_window_sampler(torch.from_numpy(img), (H, W), hy, hx, "bilinear",
                             border, backend="kernel", **kw)
    assert fj.backend == "pallas" and ft.backend == "kernel"
    want = np.asarray(fj(jnp.asarray(xs), jnp.asarray(ys)))
    got = ft(torch.from_numpy(xs), torch.from_numpy(ys)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)
    # the windows decide values: the plain route differs beyond the halos
    plain = make_window_sampler(torch.from_numpy(img), (H, W), hy, hx, "bilinear",
                                border, backend="xla", **kw)
    assert plain.backend == "xla"
    assert np.abs(plain(torch.from_numpy(xs), torch.from_numpy(ys)).numpy() - got).max() > 0.1


def test_plain_route_offsets_match_jax_xla():
    """Offsets on the plain route: folded candidate coordinates on the
    plan widened by the offset margins."""
    H, W, B, hy, hx = 40, 100, 2, 8, 10
    img, xs, ys = _case(H, W, B, hy, hx, 0, seed=1)
    kw = dict(tr=8, tc=128, offsets=_offsets(4), backend="xla")
    want = jax_sampler(jnp.asarray(img), (H, W), hy, hx, "bilinear", "clamp", **kw)(
        jnp.asarray(xs), jnp.asarray(ys))
    got = make_window_sampler(torch.from_numpy(img), (H, W), hy, hx, "bilinear",
                              "clamp", **kw)(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


ROUTE_SHAPES = [
    # (B, H, W, halo_y, halo_x, tr, tc, precision, offsets)
    # 6k pixflow_tpu_offsets side flow (14 pairs), levels 0 and 1
    (14, 331, 227, 39, 56, 8, 128, "default", _offsets(2)),
    (14, 166, 114, 19, 28, 8, 128, "default", _offsets(8)),
    # 6k pole flow (2 poles x 2 eyes), levels 0..2
    (4, 197, 945, 59, 94, 8, 128, "default", _offsets(2)),
    (4, 99, 473, 29, 47, 8, 128, "default", _offsets(8)),
    (4, 50, 237, 15, 23, 8, 128, "default", _offsets(4)),
    # the flow's static tiles (tc 16: tight-x) at the 6k side level 0
    (14, 331, 227, 39, 56, 8, 16, "float32", None),
    # over the step budget (one window of 64 leads), and one lead under it
    (64, 120, 500, 56, 186, 8, 128, "float32", None),
    (1, 120, 500, 56, 186, 8, 128, "float32", None),
    # offsets across x tiles need 128-column tiles; tiles need 8k rows
    (3, 72, 300, 10, 14, 8, 96, "default", _offsets(2)),
    (3, 72, 300, 10, 14, 12, 128, "default", None),
    (3, 72, 300, 10, 14, 8, 96, "default", None),
]


@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=lambda s: "x".join(map(str, s[:5])))
def test_route_predicate_matches_jax(shape):
    B, H, W, hy, hx, tr, tc, prec, offs = shape
    fj = jax_sampler(jnp.zeros((B, 2, H, W), jnp.float32), (H, W), hy, hx,
                     "bilinear", "clamp", tr=tr, tc=tc, precision=prec,
                     backend="pallas", offsets=offs)
    plan = fused_route_plan(B, 2, (H, W), (H, W), hy, hx, "bilinear", "clamp",
                            tr, tc, prec, "kernel", 16384, offs)
    assert (plan is not None) == (fj.backend == "pallas")


def test_route_predicate_auto_needs_output_pixels():
    args = (14, 2, (331, 227), (331, 227), 39, 56, "bilinear", "clamp", 8, 128)
    assert fused_route_plan(*args, backend="auto") is not None
    assert fused_route_plan(*args, backend="xla") is None
    small = (4, 2, (50, 237), (50, 237), 15, 23, "bilinear", "clamp", 8, 128)
    assert fused_route_plan(*small, backend="auto") is None
    assert fused_route_plan(*small, backend="kernel") is not None
    with pytest.raises(ValueError, match="unknown backend"):
        fused_route_plan(*small, backend="pallas")
