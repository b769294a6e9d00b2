"""The port's small public functions against the JAX package on the same
numpy-seeded inputs: the math helpers (``utils/math_util.py``, on torch
tensors and on numpy arrays, as the reference's ``xp=`` switch takes
them), the dense remap's two named wrappers (``ops/remap.py``) and the
eager novel-view pair (``views/novel_view.py``).

Tolerances: 5e-5 for the bicubic samplers (the reference's float32
sampling may run as 3-pass bf16, ROADMAP queue C "Precision"), 1e-6 for
the rest (float32 arithmetic in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surround360_tpu.utils.math_util as JM
import surround360_tpu.views.novel_view as JV
import surround360_tpu_torch.ops.remap as TR
import surround360_tpu_torch.utils.math_util as TM
import surround360_tpu_torch.views.novel_view as TV
from surround360_tpu.ops.remap import remap_bicubic, remap_bilinear

JR = {"remap_bilinear": remap_bilinear, "remap_bicubic": remap_bicubic}

TOL = 1e-6
BICUBIC_TOL = 5e-5
N = 7  # reflect / wrap period


def _rng(seed):
    return np.random.default_rng(seed)


def _math_cases():
    rng = _rng(0)
    x = rng.uniform(-2.0, 3.0, (5, 6)).astype(np.float32)
    corners = [rng.random((4, 5)).astype(np.float32) for _ in range(6)]
    # negative indices and indices of N and above (int32: JAX's default)
    ints = np.arange(-N, 2 * N, dtype=np.int32)
    wide = np.arange(-3 * N, 4 * N, dtype=np.int32)
    return {
        "clamp": (lambda m, a, **xp: m.clamp(a, 0.0, 1.0, **xp), [x]),
        "clamp_int": (lambda m, a, **xp: m.clamp(a, 0, N - 1, **xp), [ints]),
        "bilerp": (lambda m, *a, **xp: m.bilerp(*a), corners),
        "reflect": (lambda m, a, **xp: m.reflect(a, N, **xp), [ints]),
        "wrap": (lambda m, a, **xp: m.wrap(a, N, **xp), [wide]),
        "wrap_float": (lambda m, a, **xp: m.wrap(a, 2.5, **xp), [x]),
        "to_radians": (lambda m, a, **xp: m.to_radians(a), [x * 100]),
        "to_degrees": (lambda m, a, **xp: m.to_degrees(a), [x]),
        "gaussian_approx": (lambda m, a, **xp: m.gaussian_approx(a, 0.5, 0.6, **xp), [x]),
    }


MATH = _math_cases()


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("name", list(MATH))
def test_math_util_matches_jax(name, kind):
    fn, args = MATH[name]
    if kind == "numpy":
        want = fn(JM, *args, xp=np)
        got = fn(TM, *args)
        assert isinstance(got, np.ndarray)
    else:
        want = np.asarray(fn(JM, *[jnp.asarray(a) for a in args]))
        got = fn(TM, *[torch.from_numpy(a) for a in args])
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    assert got.dtype == want.dtype or name in ("to_radians", "to_degrees")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("border", ["constant", "clamp", "wrap"])
@pytest.mark.parametrize("name", ["remap_bilinear", "remap_bicubic"])
def test_named_remaps_match_jax(name, border):
    rng = _rng(1)
    img = rng.random((2, 3, 20, 24)).astype(np.float32)
    coords = np.stack([rng.uniform(-3, 27, (2, 18, 22)),
                       rng.uniform(-3, 23, (2, 18, 22))], axis=1).astype(np.float32)
    want = np.asarray(JR[name](jnp.asarray(img), jnp.asarray(coords), border=border))
    got = getattr(TR, name)(torch.from_numpy(img), torch.from_numpy(coords), border=border)
    tol = BICUBIC_TOL if name == "remap_bicubic" else TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
def test_generate_novel_view_matches_jax(t):
    rng = _rng(2)
    src = rng.random((2, 4, 24, 32)).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 2, 24, 32)).astype(np.float32)
    want = np.asarray(JV.generate_novel_view(jnp.asarray(src), jnp.asarray(flow), t))
    got = TV.generate_novel_view(torch.from_numpy(src), torch.from_numpy(flow), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BICUBIC_TOL)


def test_combine_novel_views_matches_jax():
    rng = _rng(3)
    B, H, W = 2, 24, 64
    views = []
    for _ in range(2):
        v = rng.random((B, 4, H, W)).astype(np.float32)
        v[:, 3] = (rng.random((B, H, W)) > 0.3) * rng.random((B, H, W))  # holes
        views.append(v)
    blend_l = rng.random((B, H, W)).astype(np.float32)
    flows = [rng.uniform(-0.5, 0.5, (B, 2, H, W)).astype(np.float32) for _ in (0, 1)]
    args = (views[0], blend_l, views[1], 1.0 - blend_l, flows[0], flows[1])
    want = np.asarray(JV.combine_novel_views(*map(jnp.asarray, args)))
    got = TV.combine_novel_views(*map(torch.from_numpy, args))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
