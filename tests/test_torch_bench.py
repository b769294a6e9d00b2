"""The port's throughput entry (``python -m surround360_tpu_torch.bench``)
against the reference's root ``bench.py``: the preset config field by
field, the ``metric`` strings (evaluated from ``bench.py``'s own
f-strings), the last stdout line's four keys in the legacy batch modes on
the CPU, the watchdog's line and exit status, and no value line without
CUDA. The subprocesses start together (one torch thread each) and each
test reads its own."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from surround360_tpu.cli.render_video import (
    PRESET_SHARPENING,
    PRESET_SIDE_FLOW_SCALE,
    QUALITY_PRESETS,
)
from surround360_tpu.render.panorama import RenderConfig as JaxConfig
from surround360_tpu_torch import bench
from surround360_tpu_torch.benchmarks.preset_table import preset_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}
LEGACY = dict(S360_BENCH_PRESET="off", S360_BENCH_EQR_WIDTH="140",
              S360_BENCH_CAM_SCALE="0.03125", S360_BENCH_FRAMES="1")
RUNS = {
    "batch2-temporal": (dict(LEGACY, S360_BENCH_BATCH="2", S360_BENCH_TEMPORAL="1"), "cpu"),
    "batch2": (dict(LEGACY, S360_BENCH_BATCH="2", S360_BENCH_TEMPORAL="0"), "cpu"),
    "batch1": (dict(LEGACY, S360_BENCH_BATCH="1"), "cpu"),
    "watchdog": (dict(S360_BENCH_PRESET="6k", S360_BENCH_TIMEOUT_S="1"), "cpu"),
    "no-cuda": ({}, "cuda"),
}


def _reference_metric(function: str, **names) -> str:
    """The f-string ``bench.py`` builds for its metric in ``function``
    (``_preset_bench``'s return, ``main``'s legacy line), evaluated with
    ``names`` bound."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    if function == "_preset_bench":
        expr = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1].value.elts[1]
    else:
        expr = next(v for n in ast.walk(fn) if isinstance(n, ast.Dict)
                    for k, v in zip(n.keys, n.values)
                    if isinstance(k, ast.Constant) and k.value == "metric"
                    and isinstance(v, ast.JoinedStr))
    return eval(compile(ast.Expression(expr), "bench.py", "eval"), {}, names)


@pytest.fixture(scope="module")
def runs():
    """Every subprocess of this file, started together."""
    procs = {}
    for name, (env, device) in RUNS.items():
        environ = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "surround360_tpu_torch.bench", "--device", device],
            cwd=REPO, env=environ, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            proc.kill()
    return out


@pytest.mark.parametrize("preset", ["3k", "4k", "6k", "8k"])
def test_preset_config_and_metric_match_bench_py(preset):
    eqr_w, eqr_h, fin_w, fin_h = QUALITY_PRESETS[preset]
    want = JaxConfig(
        eqr_width=eqr_w, eqr_height=eqr_h, final_eqr_width=fin_w, final_eqr_height=fin_h,
        sharpening=PRESET_SHARPENING, side_flow_alg="pixflow_tpu",
        polar_flow_alg="pixflow_tpu", side_flow_scale=PRESET_SIDE_FLOW_SCALE.get(preset, 1.0),
        enable_top=True, enable_bottom=True,
    )
    assert dataclasses.asdict(preset_config(preset)) == dataclasses.asdict(want)
    assert bench.preset_metric(preset) == _reference_metric(
        "_preset_bench", preset=preset, eqr_w=eqr_w, eqr_h=eqr_h, fin_w=fin_w, fin_h=fin_h)


@pytest.mark.parametrize("name", ["batch2-temporal", "batch2", "batch1"])
def test_legacy_mode_prints_bench_py_line(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-3000:]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert line["unit"] == "frames/sec" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 30.0, 4)
    env = RUNS[name][0]
    settings = dict(eqr_w=140, eqr_h=70, full_sphere=True,
                    frame_batch=int(env["S360_BENCH_BATCH"]),
                    temporal=env.get("S360_BENCH_TEMPORAL", "1") == "1")
    assert line["metric"] == _reference_metric("main", **settings)
    assert line["metric"] == bench.legacy_metric(**settings)


def test_watchdog_prints_its_line_and_exits_2(runs):
    rc, stdout, _ = runs["watchdog"]
    assert rc == 2
    line = json.loads(stdout.strip().splitlines()[-1])
    assert set(line) == KEYS and line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["metric"] == ("stereo equirect render fps (bench watchdog: GPU "
                              "unavailable/wedged, no measurement)")


def test_cuda_without_a_card_fails_with_no_value_line(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, stdout, stderr = runs["no-cuda"]
    assert rc != 0 and '"value"' not in stdout
    assert "CUDA is not available" in stderr


def test_render_views_are_the_simulators():
    from surround360_tpu_torch.capture import render_camera_views
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    rig = make_ring_rig().rescaled(0.03125)
    for a, b in zip(bench.render_views(rig), render_camera_views(rig)):
        np.testing.assert_array_equal(a, b)
