"""A whole run at test scale on the CPU: the result line's keys, the
metrics by BENCHMARK.json's names and units, the checks last; and the
trace reduction on a hand-made trace."""

import json

import pytest

from s360bench.run import result_line, run_cell
from s360bench.tests.tiny import tiny_cell
from s360bench.trace import read_chrome_trace

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def run():
    cell = tiny_cell("video_6k")
    return cell, run_cell(cell, 2**31 + 7, 1.0, False, "cpu")


def test_untraced_line(run):
    cell, r = run
    line = json.loads(json.dumps(result_line(cell, r, False, {"platform": "cpu"})))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_mem_gib")
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_trace_reduction(tmp_path):
    events = [
        _event("s360bench.window", "user_annotation", 0, 1000),
        _event("s360bench.isp", "user_annotation", 0, 200),
        _event("s360bench.render", "user_annotation", 200, 700),
        _event("cudaLaunchKernel", "cuda_runtime", 10, 5, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
        _event("void isp_k<1>(float*)", "kernel", 100, 100, correlation=1),
        _event("void window_sample_kernel<256, 4>(float const*)", "kernel", 400, 300,
               correlation=2),
        _event("Memcpy DtoH", "gpu_memcpy", 650, 100),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    d = read_chrome_trace(str(path), frames=2)
    assert d.window_s == pytest.approx(1e-3)
    assert d.busy_s == pytest.approx(450e-6)  # 100..200 and 400..750
    assert d.isp_kernel_s == pytest.approx(100e-6)
    assert d.device_ops[0] == ("void window_sample_kernel<256, 4>(float const*)",
                             pytest.approx(300e-6))
    from s360bench.run import metric_reader

    assert metric_reader("device_busy_ms.render")(d) == pytest.approx(0.225)
    # gaps: 0..100 (isp), 200..400 (render), 750..1000 (render until 900, then none)
    assert d.idle_gaps == [("s360bench.render", pytest.approx(250e-6)),
                           ("s360bench.render", pytest.approx(200e-6)),
                           ("s360bench.isp", pytest.approx(100e-6))]
    from s360bench.run import metric_reader

    d.kernel_names = {"fused_window_sample": "window_sample_kernel"}
    d.call_bytes = {"fused_window_sample": int(3.35e12 * 300e-6 * 0.5)}
    assert metric_reader("k1_roofline")(d) == pytest.approx(50.0, rel=1e-6)
    assert metric_reader("k3_roofline")(d) is None
    assert metric_reader("kernels_per_frame.render")(d) == 1.0
    assert metric_reader("device_idle_pct.render")(d) == pytest.approx(55.0)
    assert metric_reader("isp_ms_per_frame")(d) == pytest.approx(0.05)
