"""Cubemap output of the port against the JAX package: the face warps and
the padded-panorama plan (exact), the stacked faces in both formats, and a
frame with a cubemap at the JAX package's test scale (280x140, 64 px
faces)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surround360_tpu.capture import render_camera_views
from surround360_tpu.geometry.rig import make_ring_rig as jax_ring_rig
from surround360_tpu.ops import warp as JW
from surround360_tpu.render import panorama as JP
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops import remap as TR
from surround360_tpu_torch.ops import warp as TW
from surround360_tpu_torch.render import panorama as TP


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("face", JW.CUBEMAP_FACE_ORDER)
def test_cubemap_warp_equals_jax(face):
    assert TW.CUBEMAP_FACE_ORDER == JW.CUBEMAP_FACE_ORDER
    for eqr_hw, face_wh in (((96, 192), (48, 48)), ((140, 280), (64, 32))):
        got = TW.equirect_to_cubemap_warp(eqr_hw, face_wh, face)
        want = JW.equirect_to_cubemap_warp(eqr_hw, face_wh, face)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(96, 192, 48, 48), (140, 280, 64, 64),
                                   (384, 770, 192, 160)])
def test_plan_cubemap_equals_jax(shape):
    """The padded-panorama plan (warps in padded units, pad_l, pad_r) is
    host float64 arithmetic: exactly the JAX package's."""
    got = TP._plan_cubemap(*shape)
    want = JP._plan_cubemap(*shape)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["video", "photo"])
def test_cubemap_matches_jax_and_dense_wrap(fmt):
    """_cubemap (static plans on the fused window sampler's twin) against
    the JAX package's, within 5e-5 (the JAX samplers run 3-pass bf16), and
    against the port's dense wrap-border remap of each face, the
    BORDER_WRAP contract of ImageWarper.cpp:137, within 1e-5."""
    rng = np.random.default_rng(7)
    eqr_h, eqr_w, face = 96, 192, 48
    pano = rng.uniform(size=(3, eqr_h, eqr_w)).astype(np.float32)
    kw = dict(eqr_width=eqr_w, eqr_height=eqr_h, cubemap_width=face,
              cubemap_height=face, cubemap_format=fmt)
    want = np.asarray(JP._cubemap(SimpleNamespace(config=JP.RenderConfig(**kw)),
                                  jnp.asarray(pano)))
    ctx = SimpleNamespace(config=TP.RenderConfig(**kw), plans={})
    got = TP._cubemap(ctx, torch.from_numpy(pano))
    assert sorted(k[0] for k in ctx.plans) == ["cubemap_eq", "cubemap_po"]
    again = TP._cubemap(ctx, torch.from_numpy(pano))  # the cached plans
    assert torch.equal(got, again) and len(ctx.plans) == 2
    got = got.numpy()
    assert got.shape == want.shape == ((3, 2 * face, 3 * face) if fmt == "video"
                                       else (3, 6 * face, face))
    assert float(np.abs(got - want).max()) <= 5e-5
    faces = {
        f: TR.remap(torch.from_numpy(pano), torch.from_numpy(
            TW.equirect_to_cubemap_warp((eqr_h, eqr_w), (face, face), f)),
            "bicubic", "wrap").numpy()
        for f in TW.CUBEMAP_FACE_ORDER
    }
    if fmt == "video":
        row = lambda names: np.concatenate([faces[f][..., ::-1] for f in names], -1)
        dense = np.concatenate([row(("left", "right", "top")),
                                row(("bottom", "back", "front"))], -2)
    else:
        dense = np.concatenate([faces[f] for f in TW.CUBEMAP_FACE_ORDER], -2)
    assert float(np.abs(got - dense).max()) <= 1e-5


def test_render_frame_with_cubemap_matches_jax():
    """A 280x140 frame with 64 px cubemap faces: the cubemap's shape (3 x 2
    faces an eye, the eyes stacked) and both outputs against the JAX
    package's at >= 40 dB (the ring's flow is the chaotic part)."""
    rig_j = jax_ring_rig().rescaled(0.125)
    rig_t = make_ring_rig().rescaled(0.125)
    views = render_camera_views(rig_j)
    side = np.stack([views[rig_j.ids.index(s)] for s in rig_j.side_ids])
    kw = dict(eqr_width=280, eqr_height=140, side_flow_alg="pixflow_tpu",
              cubemap_width=64, cubemap_height=64, cubemap_format="video",
              sharpening=0.25)
    want, _ = JP.render_frame(JP.build_render_context(rig_j, JP.RenderConfig(**kw)),
                              jnp.asarray(side))
    got, _ = TP.render_frame(TP.build_render_context(rig_t, TP.RenderConfig(**kw)),
                             torch.from_numpy(side))
    assert tuple(got["cubemap"].shape) == (3, 2 * 2 * 64, 3 * 64)
    for key in ("cubemap", "equirect"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and np.isfinite(g).all()
        assert psnr(g, w) >= 40.0, key
