"""The PyTorch port's renderer against the JAX package and the analytic
scene.

- render_chunk_pair on a strip tall enough (665 rows) that the lazy novel
  view samples through displacement-following residual windows (the
  fused window kernel's route) in both packages;
- render_frame at the test rig (cameras x0.125, 280x140) with the full
  sphere and merged poles, and a two-frame temporal chain in which JAX's
  frame-0 state drives the port's frame 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surround360_tpu.render.panorama as JP
import surround360_tpu.views.novel_view as JNV
from surround360_tpu.capture import render_camera_views
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig
from surround360_tpu_torch.capture import render_equirect_reference
from surround360_tpu_torch.geometry.rig import make_ring_rig
from surround360_tpu_torch.ops.resize import gaussian_blur
from surround360_tpu_torch.render import panorama as TP
from surround360_tpu_torch.views import novel_view as TNV


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def _chunk_inputs():
    """3k-preset chunk geometry at 512 px cameras: 665-row overlaps, 445
    wide, 220-column chunks, verge 72 px; smooth textures and flows."""
    rng = np.random.default_rng(0)
    H, W, Wc, verge = 665, 445, 220, 72.15

    def texture():
        rgb = gaussian_blur(torch.from_numpy(rng.random((1, 3, H, W), dtype=np.float32)), 2.0)
        rgb = (rgb - rgb.amin()) / (rgb.amax() - rgb.amin())
        return torch.cat([rgb, torch.ones(1, 1, H, W)], dim=1).numpy()

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    flow = lambda s: np.stack([
        s * np.sin(2 * np.pi * gy / H), 0.3 * s * np.cos(2 * np.pi * gx / W)
    ])[None].astype(np.float32)
    wl, t_cols = TNV.lazy_warp_columns(Wc, 665, verge, "left")
    wr, _ = TNV.lazy_warp_columns(Wc, 665, verge, "right")
    return texture(), texture(), flow(3.0), flow(-2.0), wl, t_cols, wr


def test_render_chunk_pair_residual_route_matches():
    """Both eyes against the JAX package's per-render lazy novel views
    (render_lazy_novel_view x4 + combine_lazy_views); the right eye also
    against its batched render_chunk_pair. (The JAX batched call clamps
    the left eye's 2*verge slice offset to the unwidened halo and drops
    taps there; ROADMAP queue C.)"""
    il, ir, fl, fr, wl, t_cols, wr = _chunk_inputs()
    halo_y = max(8, int(0.10 * il.shape[-2]))
    assert halo_y > TNV.RESIDUAL_MIN_HALO_Y == JNV.RESIDUAL_MIN_HALO_Y
    got_l, got_r = TNV.render_chunk_pair(*map(torch.from_numpy, (il, ir, fl, fr)), wl, t_cols, wr)
    J = lambda a: jnp.asarray(a)
    views = [
        JNV.render_lazy_novel_view(J(il), J(fr), wl, t_cols, False),
        JNV.render_lazy_novel_view(J(ir), J(fl), wl, t_cols, True),
        JNV.render_lazy_novel_view(J(il), J(fr), wr, t_cols, False),
        JNV.render_lazy_novel_view(J(ir), J(fl), wr, t_cols, True),
    ]
    want_l = JNV.combine_lazy_views(views[0][0], views[1][0], views[0][1], views[1][1])
    want_r = JNV.combine_lazy_views(views[2][0], views[3][0], views[2][1], views[3][1])
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=5e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=5e-5)
    _, batched_r = JNV.render_chunk_pair(J(il), J(ir), J(fl), J(fr), wl, t_cols, wr)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(batched_r), atol=5e-5)


@pytest.fixture(scope="module")
def scene():
    jrig = jax_rig().rescaled(0.125)
    trig = make_ring_rig().rescaled(0.125)
    views = render_camera_views(jrig)
    side = np.stack([views[jrig.ids.index(s)] for s in jrig.side_ids])
    top = views[jrig.top_camera_index]
    bottom = views[jrig.bottom_camera_index]
    kw = dict(eqr_width=280, eqr_height=140, side_flow_alg="pixflow_tpu",
              polar_flow_alg="pixflow_tpu", enable_top=True, enable_bottom=True)
    return (JP.build_render_context(jrig, JP.RenderConfig(**kw)),
            TP.build_render_context(trig, TP.RenderConfig(**kw)),
            (side, top, bottom))


def test_render_frame_two_frame_chain_matches_jax(scene):
    jctx, tctx, (side, top, bottom) = scene
    jin = [jnp.asarray(a) for a in (side, top, bottom)]
    tin = [torch.from_numpy(a) for a in (side, top, bottom)]
    assert TP._merge_poles(tctx)

    out_j0, st_j0 = JP.render_frame(jctx, *jin)
    out_t0, st_t0 = TP.render_frame(tctx, *tin)
    e_j0, e_t0 = np.asarray(out_j0["equirect"]), out_t0["equirect"].numpy()
    assert e_t0.shape == e_j0.shape == (3, 280, 280)
    assert psnr(e_t0, e_j0) >= 40.0
    assert set(st_t0) == set(st_j0)
    for k in st_j0:
        assert tuple(st_t0[k].shape) == st_j0[k].shape, k

    # frame 1 of both packages from JAX's frame-0 state
    st_np = TP.state_to_numpy(TP.state_from_numpy(
        {k: np.asarray(v) for k, v in st_j0.items()}, "cpu"
    ))
    out_j1, st_j1 = JP.render_frame(jctx, *jin, state=st_j0, use_temporal=True)
    out_t1, st_t1 = TP.render_frame(
        tctx, *tin, state=TP.state_from_numpy(st_np, "cpu"), use_temporal=True
    )
    e_j1, e_t1 = np.asarray(out_j1["equirect"]), out_t1["equirect"].numpy()
    assert np.isfinite(e_t1).all()
    assert psnr(e_t1, e_j1) >= 40.0
    assert set(st_t1) == set(st_j1)

    # analytic floors of the JAX package's end-to-end tests
    expect = render_equirect_reference(tctx)
    expect_fs = render_equirect_reference(tctx, full_sphere=True)
    pad = (140 - tctx.strip_h) // 2
    band = slice(pad + 6, pad + tctx.strip_h - 6)
    for e in (e_t0, e_t1):
        left = e[:, :140]
        assert psnr(left[:, band], expect[:, band]) > 28.0
        assert psnr(left[:, 4:-4], expect_fs[:, 4:-4]) > 33.0


def test_default_flow_presets_render_matches_jax():
    """RenderConfig()'s default flow presets (pixflow_low on the ring and
    the poles) render at the test geometry, as in the JAX package."""
    jrig = jax_rig().rescaled(0.125)
    trig = make_ring_rig().rescaled(0.125)
    kw = dict(eqr_width=280, eqr_height=140, enable_top=True, enable_bottom=True)
    jcfg, tcfg = JP.RenderConfig(**kw), TP.RenderConfig(**kw)
    assert tcfg.side_flow_alg == tcfg.polar_flow_alg == jcfg.side_flow_alg == "pixflow_low"
    views = render_camera_views(jrig)
    side = np.stack([views[jrig.ids.index(s)] for s in jrig.side_ids])
    ins = (side, views[jrig.top_camera_index], views[jrig.bottom_camera_index])
    want = JP.render_frame(JP.build_render_context(jrig, jcfg), *map(jnp.asarray, ins))[0]
    got = TP.render_frame(TP.build_render_context(trig, tcfg), *map(torch.from_numpy, ins))[0]
    e_j, e_t = np.asarray(want["equirect"]), got["equirect"].numpy()
    assert e_t.shape == e_j.shape == (3, 280, 280) and np.isfinite(e_t).all()
    assert psnr(e_t, e_j) >= 40.0
