"""The benchmark folder's harnesses in the port against the JAX package:
``make_jitted_renderer``, ``flow_quality``, ``preset_table``,
``preset_quality``, ``profile_stages`` and ``trace_grid_economics``, at the
test rig (cameras x0.125, 280x140 per eye), on the CPU."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import surround360_tpu.cli.render_video as JRV  # noqa: E402
import surround360_tpu.render.panorama as JP  # noqa: E402
from surround360_tpu.capture import render_camera_views  # noqa: E402
from surround360_tpu.geometry.rig import make_ring_rig as jax_rig  # noqa: E402
from surround360_tpu_torch.benchmarks import (  # noqa: E402
    flow_quality,
    preset_quality,
    preset_table,
    profile_stages,
    trace_grid_economics,
)
from surround360_tpu_torch.cli import render_video as TRV  # noqa: E402
from surround360_tpu_torch.geometry.rig import make_ring_rig  # noqa: E402
from surround360_tpu_torch.render import panorama as TP  # noqa: E402
from test_flow_quality import THRESHOLDS  # noqa: E402

TINY = (280, 140, 0, 0)  # a preset at the test geometry, no final resize
# the keys of the reference harnesses' rows (benchmarks/preset_table.py,
# benchmarks/preset_quality.py)
TABLE_KEYS = {"preset", "mode", "eqr", "ms_per_frame", "fps", "compile_s", "peak_hbm_gb"}
QUALITY_KEYS = {"preset", "eqr", "psnr_full_L", "psnr_full_R", "psnr_band_L",
                "psnr_caps_L", "lr_agreement"}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def scene():
    jrig = jax_rig().rescaled(0.125)
    trig = make_ring_rig().rescaled(0.125)
    views = render_camera_views(jrig)
    kw = dict(eqr_width=280, eqr_height=140, side_flow_alg="pixflow_tpu",
              polar_flow_alg="pixflow_tpu", enable_top=True, enable_bottom=True)
    return (JP.build_render_context(jrig, JP.RenderConfig(**kw)),
            TP.build_render_context(trig, TP.RenderConfig(**kw)), trig, views)


def _inputs(rig, views):
    side = np.stack([views[rig.ids.index(s)] for s in rig.side_ids])
    return side, views[rig.top_camera_index], views[rig.bottom_camera_index]


def test_make_jitted_renderer_chain_equals_render_frame(scene):
    """The reference's calling pattern (a priorless renderer for frame 0, a
    temporal one after it) gives render_frame's chain exactly; ``staged``
    is accepted and changes nothing."""
    _, tctx, trig, views = scene
    tin = [torch.from_numpy(a) for a in _inputs(trig, views)]
    render0 = TP.make_jitted_renderer(tctx)
    render_t = TP.make_jitted_renderer(tctx, use_temporal=True, staged=True)
    out0, st0 = render0(*tin, None)
    out1, st1 = render_t(*tin, st0)
    want0, wst0 = TP.render_frame(tctx, *tin)
    want1, wst1 = TP.render_frame(tctx, *tin, state=wst0, use_temporal=True)
    assert torch.equal(out0["equirect"], want0["equirect"])
    assert torch.equal(out1["equirect"], want1["equirect"])
    assert set(st1) == set(wst1) and all(torch.equal(st1[k], wst1[k]) for k in st1)
    assert not torch.equal(out1["equirect"], out0["equirect"])  # the prior was used


def test_make_jitted_renderer_matches_jax(scene):
    """Two chained frames of the port's and the JAX package's
    make_jitted_renderer, the port's frame 1 from JAX's frame-0 state:
    >= 40 dB each."""
    jctx, tctx, trig, views = scene
    ins = _inputs(trig, views)
    jin = [jnp.asarray(a) for a in ins]
    tin = [torch.from_numpy(a) for a in ins]
    jout0, jst0 = JP.make_jitted_renderer(jctx)(*jin, None)
    tout0, _ = TP.make_jitted_renderer(tctx)(*tin, None)
    assert psnr(tout0["equirect"].numpy(), np.asarray(jout0["equirect"])) >= 40.0
    st = TP.state_from_numpy({k: np.asarray(v) for k, v in jst0.items()}, "cpu")
    jout1, _ = JP.make_jitted_renderer(jctx, use_temporal=True)(*jin, jst0)
    tout1, _ = TP.make_jitted_renderer(tctx, use_temporal=True)(*tin, st)
    e_t1 = tout1["equirect"].numpy()
    assert e_t1.shape == (3, 280, 280) and np.isfinite(e_t1).all()
    assert psnr(e_t1, np.asarray(jout1["equirect"])) >= 40.0


@pytest.mark.parametrize("scene_name", sorted(THRESHOLDS))
def test_flow_quality_scene_under_thresholds_in_both_packages(scene_name):
    """The port's scene through JAX's interpolation_rmse and the port's,
    both under tests/test_flow_quality.py's thresholds for pixflow_tpu."""
    from benchmarks.flow_quality import interpolation_rmse as jax_rmse

    i0, i1, mid = flow_quality.build_scene(scene_name)
    base = flow_quality.no_flow_rmse(i0, i1, mid)
    max_abs, factor = THRESHOLDS[scene_name]
    for rmse in (jax_rmse(i0, i1, mid, "pixflow_tpu"),
                 flow_quality.interpolation_rmse(i0, i1, mid, "pixflow_tpu", "cpu")):
        assert rmse < max_abs and rmse < base / factor, (scene_name, rmse, base)



def test_smoke_flow_thresholds_are_the_jax_tests():
    """chip_smoke.py holds pixflow_tpu on the card to the JAX package's own
    thresholds (it cannot import the JAX tests there)."""
    import chip_smoke as cs

    assert cs.FLOW_THRESHOLDS == THRESHOLDS


def test_flow_quality_scenes_near_the_references():
    """The numpy / scipy scenes against the reference's OpenCV ones: equal
    where nothing is resampled (integer motions), within 5e-3 where a cubic
    warp is (Keys cubic there, B-spline here; measured 3.1e-3)."""
    import benchmarks.flow_quality as ref

    for name in flow_quality.SCENES:
        for got, want in zip(flow_quality.build_scene(name), ref.build_scene(name)):
            assert got.shape == want.shape == (120, 160) and got.dtype == np.float32
            tol = 1e-6 if name in ("translation", "occlusion") else 5e-3
            assert float(np.abs(got - want).max()) <= tol, name


def test_flow_quality_table_on_cpu(capsys):
    rows = flow_quality.main(["--device", "cpu"])
    assert [r[0] for r in rows] == flow_quality.SCENES
    for scene_name, base, r_low, r_tpu in rows:  # pixflow_low loses at the occlusion
        assert r_tpu < base and np.isfinite(r_low), scene_name
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["scene", "no-flow", "pixflow_low", "pixflow_tpu", "tpu/low"]


@pytest.fixture()
def tiny_preset(monkeypatch):
    monkeypatch.setitem(TRV.QUALITY_PRESETS, "tiny", TINY)
    monkeypatch.setitem(JRV.QUALITY_PRESETS, "tiny", TINY)


@pytest.mark.parametrize("temporal,cubemap", [(False, False), (True, True)],
                         ids=["priorless", "temporal+cubemap"])
def test_preset_table_rows(tiny_preset, scene, temporal, cubemap):
    """Rows with the reference's keys at a tiny preset: the frames timed,
    their median, the mode string as the reference writes it."""
    _, _, trig, views = scene
    rows = preset_table.run("cpu", ["tiny"], reps=2, temporal=temporal,
                            cubemap=cubemap, rig=trig, views=views)
    (row,) = rows
    assert TABLE_KEYS <= set(row) and "error" not in row
    assert row["mode"] == ("temporal+cubemap" if temporal else "priorless")
    assert row["eqr"] == "280x140/eye" and len(row["frames_ms"]) == 2
    assert row["median_ms"] > 0 and np.isnan(row["peak_hbm_gb"])


def test_preset_table_failure_is_a_row(scene, capsys):
    _, _, trig, views = scene
    rows = preset_table.run("cpu", ["no_such_preset"], reps=1, rig=trig, views=views)
    assert rows[0]["preset"] == "no_such_preset" and "KeyError" in rows[0]["error"]
    assert "FAILED" in capsys.readouterr().out


def test_preset_quality_row_matches_jax_harness(tiny_preset, scene, monkeypatch, capsys):
    """The port's row at a tiny preset, a 2-frame temporal chain, beside the
    JAX harness's row on the same scene: the reference's keys, PSNRs within
    0.5 dB of JAX's, the full sphere above 33 dB (the JAX end-to-end
    tests' floor at this size)."""
    import benchmarks.preset_quality as ref

    monkeypatch.setenv("S360_PRESETS", "tiny")
    monkeypatch.setenv("S360_PRESET_CAM_SCALE", "0.125")
    monkeypatch.setenv("S360_PRESET_TEMPORAL", "2")
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # its TPU cache
    ref.main()
    jrow = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][0]
    _, _, trig, views = scene
    (row,) = preset_quality.run("cpu", ["tiny"], n_chain=2, rig=trig, views=views)
    assert set(row) == set(jrow) == QUALITY_KEYS
    assert row["eqr"] == jrow["eqr"] == "280x140/eye"
    for k in QUALITY_KEYS - {"preset", "eqr"}:
        assert abs(row[k] - jrow[k]) <= 0.5, (k, row[k], jrow[k])
    assert min(row["psnr_full_L"], row["psnr_full_R"]) > 33.0


def test_profile_stages_settings_and_table(capsys, monkeypatch):
    for k in [k for k in os.environ if k.startswith("S360_PROF_")]:
        monkeypatch.delenv(k)
    s = profile_stages.settings()
    assert (s["eqr_w"], s["cam_scale"], s["reps"], s["full_sphere"], s["side_flow_scale"],
            s["polar_flow_scale"], s["flow_alg"]) == (
        1008, 0.25, 5, True, 1.0, 0.25, "pixflow_tpu")
    assert len(s) == 7
    rows = profile_stages.run("cpu", eqr_w=280, cam_scale=0.125, reps=1)
    assert list(rows)[:6] == ["frame", "projection", "side_flow", "novel_view", "poles",
                              "output"]
    assert all(r["host_ms"] > 0 and r["stream_ms"] is None for r in rows.values())
    out = capsys.readouterr().out
    assert "stage breakdown @ 280x140/eye, cams x0.125, cpu" in out
    assert json.loads(out.strip().splitlines()[-2]).keys() == rows.keys()


def test_trace_grid_economics_lists_every_site(scene, capsys):
    """One frame with the kernels' record on: a line per (kernel, site,
    offsets) with its calls and geometry; at 280 px the K1 sites of the
    side projection, the fisheye strips and the pole warp."""
    _, tctx, _, _ = scene
    rows = trace_grid_economics.run("cpu", ctx=tctx)
    sites = {(r["kernel"], r["site"]) for r in rows}
    for site in ("side_projection", "fisheye_strip", "pole_warp"):
        assert ("fused_window_sample", site) in sites
    for r in rows:
        assert r["launches"] >= 1 and r["T"] * r["L"] * r["P"] > 0 and r["C"] >= 1
    fisheye = next(r for r in rows if r["site"] == "fisheye_strip")
    assert fisheye["launches"] == 2  # top and bottom
    assert "# ran ok: equirect (3, 280, 280)" in capsys.readouterr().out


_MAINS = [profile_stages, preset_table, preset_quality, flow_quality, trace_grid_economics]


@pytest.mark.parametrize(
    "call",
    [functools.partial(m.main, []) for m in _MAINS] + [lambda: flow_quality.interpolation_rmse(
        *flow_quality.build_scene("translation"), "pixflow_tpu")],
    ids=[m.__name__.rsplit(".", 1)[-1] for m in _MAINS] + ["interpolation_rmse"])
def test_harnesses_default_to_cuda(call, monkeypatch):
    """Each harness's main(), and interpolation_rmse called with the
    reference's four arguments, run on the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
