"""The benchmark's device scene and sensor model against the port's host
simulator and chip_smoke.py's sensor model, at a small size."""

import numpy as np
import pytest
import torch

from s360bench import feed, scene


@pytest.fixture(scope="module")
def rig():
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    return make_ring_rig(side_resolution=(64, 64), fisheye_resolution=(64, 64))


def test_views_match_the_simulator(rig):
    from surround360_tpu_torch.capture.simulator import render_camera_views

    distance = 750.0
    want = render_camera_views(rig, scene_distance=distance)
    for cam, w in zip(rig.cameras, want):
        rays = scene.camera_rays(cam, "cpu")
        got = scene.render_view(cam, rays, distance, [0.0] * 6, np.eye(3))
        np.testing.assert_allclose(got.numpy(), w[:3], atol=2e-6)


def test_phases_and_rotation_move_the_scene(rig):
    cam = rig.cameras[1]
    rays = scene.camera_rays(cam, "cpu")
    a = scene.render_view(cam, rays, 750.0, [0.0] * 6, np.eye(3))
    b = scene.render_view(cam, rays, 750.0, [0.3] * 6, np.eye(3))
    c = scene.render_view(cam, rays, 750.0, [0.0] * 6, scene.rotation(0.01, 0.0, 0.0))
    assert (a - b).abs().mean() > 0.01 and (a - c).abs().mean() > 1e-3


def test_sensor_model_matches_chip_smoke(rig):
    import chip_smoke
    from surround360_tpu_torch.isp.pipeline import IspConfig

    from s360bench.reference.isp import IspConfig as RefIspConfig

    cam = rig.cameras[3]
    view = scene.render_view(cam, scene.camera_rays(cam, "cpu"), 750.0, [0.2] * 6, np.eye(3))
    kw = {k: feed.tuples(v) for k, v in chip_smoke.ISP_KW.items()}
    want = chip_smoke._sensor_raw12(np.concatenate([view.numpy(), np.ones_like(view[:1])]),
                                    IspConfig(**kw))
    got = feed.sensor_raw12(view, RefIspConfig(**kw), None)
    assert int((got.numpy().astype(np.int64) - want).__abs__().max()) <= 1
    u16 = feed.to_uint16(got).to(torch.int32).numpy()
    np.testing.assert_array_equal(u16, (got.numpy() << 4) | (got.numpy() >> 8))


def test_isp_configs_are_drawn_per_camera():
    from s360bench.run import resolve

    cfg = resolve("raw_6k").config
    a, b = feed.isp_configs(cfg, 7, 17), feed.isp_configs(cfg, 7, 17)
    assert a == b and len({x["white_balance_gain"] for x in a}) == 17
    assert feed.isp_configs(cfg, 8, 17) != a
