"""BENCHMARK.json against the contract's shape, and every cell resolved
to its files by name."""

import json
import os
import re

import pytest

from s360bench.feed import Feed, load_traffic
from s360bench.run import BENCH_DIR, ROOT, load_benchmark, metric_reader, resolve

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["s360bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("s360bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    for e in names:
        assert NAME.match(e), e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = resolve(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(metric_reader(m["name"]))
    # a frame without a prior is compared by its inputs and its ring's
    # flows, and may be by its single pairs, its pole flows and the frame;
    # chained frames, which only a mix with the prior has, by their own
    # numbers
    still = {"start_inputs_rel", "still_ring_flow_p50_px"}
    optional = {"still_ring_pair_p25_px", "still_pole_flow_p25_px",
                "still_anchored_rms_levels", "still_rms_levels"}
    chain = {"chain_rms_levels", "chain_state_rel"}
    assert still <= set(c.limits) <= still | optional | chain
    prior = c.traffic.get("prior", True)
    assert set(c.limits) & chain == (chain if prior else set())
    assert c.traffic == load_traffic(next(w["traffic"] for w in BENCH["workloads"]
                                          if w["name"] == cell))


def test_every_file_is_named():
    metrics = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics")) if f.endswith(".py")}
    assert metrics == files
    limits = {f[:-5] for f in os.listdir(os.path.join(BENCH_DIR, "limits"))}
    assert limits == set(CELLS)
    configs = {c["file"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    assert len(configs) == len(BENCH["configs"])


def test_rig_is_the_surround360_rig():
    """The configurations' rig is make_ring_rig() with no cut."""
    from surround360_tpu_torch.geometry.rig import make_ring_rig

    from s360bench.reference.system import tuples

    full = make_ring_rig()
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            rig = make_ring_rig(**{k: tuples(v) for k, v in json.load(f)["rig"].items()})
        assert rig.ids == full.ids
        for a, b in zip(rig.cameras, full.cameras):
            for x, y in zip(a, b):
                assert (x == y).all()


def test_stream_walks_the_pool_forth_and_back():
    feed = Feed.__new__(Feed)
    feed.pool_frames = 4
    seq = [feed.index(k) for k in range(14)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0, 1]
    assert all(a != b for a, b in zip(seq, seq[1:]))
