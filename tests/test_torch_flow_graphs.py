"""CUDA graphs of the flow's pyramid levels (``flow/pixflow.py``).

On the CPU: which calls are captured (every level on a CUDA device, K3's
levels too, unless the per-call hook has a reader), the key, the device
constants built once, and the graphed level loop itself, run with a
stand-in for the capture that replays a level's body on the same
persistent buffers, so the loading of inputs, the chaining of outputs,
the search's own graph, the counters and the launches a graph holds are
held to the eager flow bit for bit. ``gpu``-marked: the same on the card
with real graphs, K3's launches counted at each replay, and the search's
and the K3 levels' spans free of copies and synchronises. No JAX here, so
the file runs on the card with ``--noconftest``.
"""

import collections
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from surround360_tpu_torch import cuda_build
from surround360_tpu_torch.flow import (
    HINT_DOWN,
    HINT_LEFT,
    HINT_RIGHT,
    compute_flow,
    make_flow_params,
)
from surround360_tpu_torch.flow import pixflow as TPF
from surround360_tpu_torch.ops import fused_window as fw
from surround360_tpu_torch.ops import resize as R
from surround360_tpu_torch.ops import window_sampler as WS
from surround360_tpu_torch.ops.window_sampler import make_window_sampler
from surround360_tpu_torch.utils import tracing
from surround360_tpu_torch.views.novel_view import prepare_pair_flows

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
POLE_HALOS = dict(window_halo_y_frac=0.30, window_halo_x_frac=0.10)


def _clear():
    TPF._DEVICE_GRAPHS.clear()


@pytest.fixture
def fake_graphs(monkeypatch):
    """Levels on the CPU taken through the graphed loop: "capture" runs
    the level once as the warm-up and returns a graph whose replay runs it
    again on the same buffers, with its launches held back as a real
    replay's are (no Python runs there); the first replay lists them, as
    a capture would. Yields the list of those graphs."""
    made = []

    class Replayed:
        def __init__(self, step, out):
            self.step, self.out, self.replays, self.launches = step, out, 0, []

        def replay(self):
            with cuda_build.held() as launches:
                self.out.copy_(self.step())
            if not self.replays:
                self.launches.extend(launches)
            self.replays += 1

    def capture(step, out, dg):
        step()
        made.append(Replayed(step, out))
        return made[-1], made[-1].launches

    monkeypatch.setattr(TPF, "_graphable", lambda device: True)
    monkeypatch.setattr(TPF, "_capture", capture)
    _clear()
    yield made
    _clear()


def _texture(g, B, H, W):
    rgb = R.gaussian_blur(torch.rand((B, 3, H, W), generator=g), 1.5)
    rgb = (rgb - rgb.amin()) / (rgb.amax() - rgb.amin())
    return torch.cat([rgb, torch.ones(B, 1, H, W)], dim=1)


def _frames(seed, n, B, H, W, device=CPU):
    """n frames of a pair (B, 4, H, W) each: a texture and its copy
    shifted by a few pixels that grow with the frame."""
    g = torch.Generator().manual_seed(seed)
    base = _texture(g, B, H, W + 16)
    return [(base[..., 8:8 + W].to(device), base[..., 8 - 2 - k:8 - 2 - k + W].to(device))
            for k in range(n)]


def _chain(frames, params, pair: bool, hint, site):
    """The temporal chain: frame 0 without a prior, then each frame with
    the last one's flows and images. ``pair``: both directions through
    ``prepare_pair_flows``, else one ``compute_flow`` with ``hint``."""
    outs, prev = [], None
    for k, (a, b) in enumerate(frames):
        temporal = k > 0
        if pair:
            kw = {}
            if temporal:
                kw = dict(prev_flow_l_to_r=prev[0], prev_flow_r_to_l=prev[1],
                          prev_overlap_l=frames[k - 1][0], prev_overlap_r=frames[k - 1][1])
            flows = prepare_pair_flows(a, b, params, use_temporal=temporal, site=site, **kw)
        else:
            h = torch.full((a.shape[0],), hint, dtype=torch.int32, device=a.device)
            kw = {}
            if temporal:
                kw = dict(prev_flow=prev[0], prev_img0=frames[k - 1][0],
                          prev_img1=frames[k - 1][1])
            flows = (compute_flow(a, b, params, hint=h, use_temporal=temporal, site=site,
                                  **kw),)
        outs.append(flows)
        prev = flows
    return outs


def _assert_same(got, want):
    for g_frame, w_frame in zip(got, want, strict=True):
        for g, w in zip(g_frame, w_frame, strict=True):
            assert g.shape == w.shape
            assert torch.equal(g, w), float((g - w).abs().max())


# ---------------------------------------------------------------------------
# which levels are captured
# ---------------------------------------------------------------------------


def test_every_level_is_graphed_unless_the_hook_has_a_reader(monkeypatch):
    """A call graphs its levels on a CUDA device, whichever route its
    samplers take, and never on the CPU; while the per-call hook has a
    reader (``fw.recorded()`` open, or a caller's hook in place of
    ``fw._record``) it runs eagerly."""
    assert TPF._graphed(CUDA) is True and TPF._graphed(CPU) is False
    with fw.recorded():
        assert TPF._graphed(CUDA) is False
    assert TPF._graphed(CUDA) is True
    hook = fw._record
    monkeypatch.setattr(fw, "_record", lambda *a: hook(*a))
    assert TPF._graphed(CUDA) is False
    monkeypatch.setattr(fw, "_record", hook)
    assert TPF._graphed(CUDA) is True


# (ranking distance or None, tile columns): the flow's offset ranking at
# its widest and narrowest set, and the plain fused route with tight-x
# tiles (16 columns, off the 128 grid) and with aligned ones
SAMPLER_ROUTES = {"offsets_d8": (8, 128), "offsets_d1": (1, 128), "plain_tight": (None, 16),
                  "plain_aligned": (None, 128)}


@pytest.mark.parametrize("route", list(SAMPLER_ROUTES))
@pytest.mark.parametrize("B,H,W", [(2, 24, 40), (1, 64, 128), (2, 128, 160), (14, 113, 165),
                                   (1, 40, 300), (1, 64, 640)])
def test_fused_sampler_tile_origins_are_one_device_constant(monkeypatch, route, B, H, W):
    """A fused-route sampler (K2 / K3) copies nothing from the host when
    it is built, so that it can be built under a graph's capture: its tile
    origins are one int32 device constant (``resize.on_device``), the same
    tensor at the next build, holding the plan's origins (rows ``ty * tr``;
    columns ``tx * tc``, floored to the 128 grid unless the plain route's
    columns lie off it)."""
    d, tc = SAMPLER_ROUTES[route]
    params = make_flow_params("pixflow_tpu_offsets")
    offs = None if d is None else TPF._rank_offsets(d, TPF._PROBES)
    lv = TPF._level_plan(B, H, W, params, True)
    made = []
    on_device = WS.on_device
    monkeypatch.setattr(WS, "on_device",
                        lambda make, *a: made.append((make, on_device(make, *a))) or made[-1][1])
    src = torch.zeros((B, 2, H, W))
    builds = []
    for _ in range(2):
        made.clear()
        fn = make_window_sampler(src, (H, W), lv.halo_y, lv.halo_x, "bilinear", "clamp",
                                 tr=8, tc=tc, precision=params.error_sampler_precision,
                                 backend="kernel", offsets=offs)
        builds.append([t for m, t in made if m is WS._tile_origins])
    plan = WS.fused_route_plan(B, 2, (H, W), (H, W), lv.halo_y, lv.halo_x, "bilinear",
                               "clamp", 8, tc, params.error_sampler_precision,
                               backend="kernel", offsets=offs)
    assert plan is not None and fn.backend == "kernel"
    (first,), (second,) = builds
    assert first is second and first.dtype == torch.int32
    tiles = np.arange(plan.nty * plan.ntx)
    cols = (tiles % plan.ntx) * plan.tc
    tight = offs is None and bool((cols % 128).any())
    assert first[0].tolist() == ((tiles // plan.ntx) * plan.tr).tolist()
    assert first[1].tolist() == (cols if tight else cols // 128 * 128).tolist()


def test_capture_predicate_splits_the_offsets_pyramid(fake_graphs):
    """pixflow_tpu_offsets: levels of 16384 px or more rank through K3,
    the coarser ones take the plain route, and every level of the call
    is captured and replayed, K3's with the others."""
    params = make_flow_params("pixflow_tpu_offsets")
    sizes = TPF._pyramid_sizes(128, 256, params)
    probes = TPF._PROBES
    routes = []
    for i, (h, w) in enumerate(sizes):
        lv = TPF._level_plan(2, h, w, params, i == 0)
        routes.append(make_window_sampler(
            torch.zeros((2, 2, h, w)), (h, w), lv.halo_y, lv.halo_x, "bilinear", "clamp",
            tr=TPF._OFFSET_RANK_TR, tc=TPF._OFFSET_RANK_TC,
            precision=params.error_sampler_precision,
            offsets=TPF._rank_offsets(lv.offsets[0], probes)).backend)
    assert routes == ["kernel" if h * w >= 16384 else "xla" for h, w in sizes]
    assert routes == ["kernel", "xla", "xla", "xla"]
    (a, b), = _frames(13, 1, 2, 256, 512)
    with tracing.recording():
        compute_flow(a, b, params, site="k3_site")
    levels = [s for s in tracing.session() if s.name == "flow.level"]
    assert [s.attrs["h"] * s.attrs["w"] for s in levels] == [h * w for h, w in sizes[::-1]]
    assert all(s.attrs["graphed"] is True for s in levels)
    assert [s.counts for s in levels] == [{"flow.graph.capture": 1}] * len(sizes)
    assert len(fake_graphs) == len(sizes) and all(g.replays == 1 for g in fake_graphs)


def test_graph_key_separates_what_the_launches_depend_on():
    params = make_flow_params("pixflow_tpu")
    base = dict(device=CUDA, site="side_flow", params=params, use_temporal=True, B=14,
                level=2, size=(57, 83), work=(227, 331))
    key = TPF._graph_key(**base)
    assert TPF._graph_key(**base) == key  # L->R and R->L share it
    for name, other in [("use_temporal", False), ("B", 4), ("level", 1),
                        ("size", (58, 83)), ("work", (228, 331)),
                        ("device", torch.device("cuda", 1)), ("site", "pole_flow"),
                        ("params", params._replace(residual_rebase=True))]:
        assert TPF._graph_key(**dict(base, **{name: other})) != key, name


# ---------------------------------------------------------------------------
# constants built once per device
# ---------------------------------------------------------------------------


def test_level_constants_and_weights_are_built_once_per_device(monkeypatch):
    """A level's device constants (the gradient step, the probe deltas),
    its resize and blur matrices and the convolution taps of the long-axis
    routes all come from ``resize.on_device``: a second call reads the
    same tensors."""
    g = torch.Generator().manual_seed(3)
    a, b = (torch.rand((2, 20, 36), generator=g) for _ in range(2))
    ones = torch.ones_like(a)
    params = make_flow_params("pixflow_tpu")
    seen: list = []
    on_device = R.on_device
    monkeypatch.setattr(R, "on_device", lambda *a: seen.append(on_device(*a)) or seen[-1])
    runs = []
    for _ in range(2):
        seen.clear()
        TPF._propagation_and_search(a, b, ones, ones, torch.zeros((2, 2, 20, 36)),
                                    params, is_finest=False)
        R.gaussian_blur(torch.rand((1, 4, 2600), generator=g), 1.0)
        R.resize_cubic(torch.rand((1, 2, 1300), generator=g), (2, 2600))
        runs.append(list(seen))
    first, second = runs
    assert len(first) == len(second) > 10
    assert all(x is y for x, y in zip(first, second))
    eps = R.device_constant((TPF.GRAD_EPSILON, 0.0), CPU)
    assert eps is R.device_constant((TPF.GRAD_EPSILON, 0.0), CPU)
    assert eps.dtype == torch.float32
    assert eps.tolist() == torch.tensor([TPF.GRAD_EPSILON, 0.0]).tolist()


def test_pinned_tensors_outlive_the_cache():
    """What a capture reads is pinned: the same tensor comes back after
    the cache has dropped it, and nothing is pinned outside ``pinning``."""
    with R.pinning():
        pinned = R.device_constant((0.125, 0.25, 0.375), CPU)
    loose = R.device_constant((0.5, 0.75), CPU)
    R._cached_on_device.cache_clear()
    assert R.device_constant((0.125, 0.25, 0.375), CPU) is pinned
    assert R.device_constant((0.5, 0.75), CPU) is not loose
    assert not getattr(R._PINNING, "on", False)


# ---------------------------------------------------------------------------
# the graphed level loop, on the CPU with a stand-in capture
# ---------------------------------------------------------------------------


def _eager_then_graphed(fake_graphs, monkeypatch, run):
    monkeypatch.setattr(TPF, "_graphable", lambda device: False)
    _clear()
    want = run()
    monkeypatch.setattr(TPF, "_graphable", lambda device: True)
    _clear()
    got = run()
    return got, want


@pytest.mark.parametrize("preset", ["pixflow_tpu", "pixflow_search_20", "pixflow_tpu_fast"])
def test_graphed_pair_and_pole_chains_equal_eager(fake_graphs, monkeypatch, preset):
    """A 3-frame temporal chain of both pair directions and of the pole
    call: the graphed loop's flows equal the eager ones bit for bit."""
    params = make_flow_params(preset)
    pair = _frames(0, 3, 2, 64, 112)
    pole = _frames(1, 3, 4, 64, 56)

    def run():
        return (_chain(pair, params, True, HINT_LEFT, "side_flow")
                + _chain(pole, params._replace(**POLE_HALOS), False, HINT_DOWN, "pole_flow"))

    got, want = _eager_then_graphed(fake_graphs, monkeypatch, run)
    _assert_same(got, want)
    assert fake_graphs and all(g.replays >= 1 for g in fake_graphs)


@pytest.mark.parametrize("reader", ["recorded", "hook"])
def test_graphed_loop_keeps_k3_levels_eager(fake_graphs, monkeypatch, reader):
    """While the per-call hook has a reader, ``fw.recorded()`` or a
    caller's own hook in place of ``fw._record``, every level of
    pixflow_tpu_offsets runs eagerly, its K3 finest level too: the calls
    the reader sees and the flows are the eager run's."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _frames(2, 2, 1, 256, 256)

    def run():
        calls = []
        if reader == "hook":
            hook = fw._record
            monkeypatch.setattr(fw, "_record", lambda kernel, site, args, kw, out: (
                calls.append((kernel, site, tuple(args[3].shape))),
                hook(kernel, site, args, kw, out)))
        with tracing.recording(), fw.recorded() if reader == "recorded" else _nothing() as rec:
            out = _chain(frames, params, False, HINT_LEFT, "k3_site")
        levels = [s for s in tracing.session() if s.name == "flow.level"]
        if reader == "hook":
            monkeypatch.setattr(fw, "_record", hook)
        else:
            calls = {k: (v[3], v[0][3].shape) for k, v in rec.items()}
        return out, calls, levels

    (got, got_calls, levels), (want, want_calls, _) = _eager_then_graphed(
        fake_graphs, monkeypatch, run)
    _assert_same(got, want)
    assert want_calls and got_calls == want_calls
    assert {c[0] for c in want_calls} == {fw.K3}
    assert levels and all(s.attrs["graphed"] is False for s in levels)
    assert all(s.counts == {"flow.graph.eager": 1} for s in levels)
    assert fake_graphs == [] and not fw.record_open()


@contextmanager
def _nothing():
    yield None


def test_graphed_k3_levels_equal_eager(fake_graphs, monkeypatch):
    """pixflow_tpu_offsets with a K3 finest level and no reader of the
    per-call hook: every level, K3's too, is taken through the graphed
    loop (captured at the first call of its key, replayed after), and the
    flows of a 3-frame chain equal the eager run's bit for bit."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _frames(2, 3, 1, 256, 256)
    k3_calls = []
    folded = fw.fused_window_sample_folded_reference

    def run():
        k3_calls.clear()
        with tracing.recording():
            out = _chain(frames, params, False, HINT_LEFT, "k3_site")
        return out, [s for s in tracing.session() if s.name == "flow.level"]

    monkeypatch.setattr(fw, "fused_window_sample_folded_reference",
                        lambda *a, **kw: k3_calls.append(kw["offsets"]) or folded(*a, **kw))
    (got, levels), (want, _) = _eager_then_graphed(fake_graphs, monkeypatch, run)
    _assert_same(got, want)
    assert k3_calls  # the finest level ranks through K3 (its CPU twin)
    assert all(s.attrs["graphed"] is True for s in levels)
    finest = [s for s in levels if s.attrs["finest"]]
    assert finest[0].attrs["h"] * finest[0].attrs["w"] >= 16384
    # frame 0 and frame 1 (the first with the temporal prior) capture
    assert [s.counts for s in finest] == [{"flow.graph.capture": 1}] * 2 + [
        {"flow.graph.replay": 1}]


# two K3 sites of a temporal chain, (B, H, W, the params' halos) on the
# CPU and on the card: each ranks its finest levels through K3
K3_SITES = {"side_k3": ((1, 256, 256), (4, 256, 384), {}),
            "pole_k3": ((1, 256, 256), (2, 256, 256), POLE_HALOS)}


def _k3_frames(device, n):
    """Per K3 site, ``n`` frames of its pair on ``device``."""
    return {site: _frames(seed, n, *shapes[device.type == "cuda"], device)
            for seed, (site, (*shapes, _)) in enumerate(K3_SITES.items())}


def _k3_frame(frames, k, prev, params):
    """Frame ``k`` of each K3 site's chain, one ``compute_flow`` (hint
    LEFT) on the site's flow of frame k - 1 (``prev``)."""
    out = {}
    for site, (*_, halos) in K3_SITES.items():
        (a, b), kw = frames[site][k], {}
        if k:
            kw = dict(prev_flow=prev[site], prev_img0=frames[site][k - 1][0],
                      prev_img1=frames[site][k - 1][1])
        hint = torch.full((a.shape[0],), HINT_LEFT, dtype=torch.int32, device=a.device)
        out[site] = compute_flow(a, b, params._replace(**halos), hint=hint,
                                 use_temporal=k > 0, site=site, **kw)
    return out


def _k3_calls(monkeypatch, when=lambda: True):
    """Counts the K3 calls the samplers make while ``when()``, by (site,
    offsets): the key of the per-call record."""
    calls = collections.Counter()
    folded = WS.fused_window_sample_folded

    def spy(*args, **kw):
        if kw.get("offsets") and when():
            calls[(kw["site"], tuple(kw["offsets"]))] += 1
        return folded(*args, **kw)

    monkeypatch.setattr(WS, "fused_window_sample_folded", spy)
    return calls


def _recorded_k3(rec):
    return {(site, offs): v[3] for (kernel, site, offs), v in rec.items() if kernel == fw.K3}


def test_record_equals_the_replayed_calls(fake_graphs, monkeypatch):
    """A reader of the per-call hook sees an eager run, while frames with
    no reader replay graphs. Per (site, offsets), a recorded frame makes
    the K3 calls that a replayed frame's graphs run (the stand-in replays
    them in Python), and the same flows, bit for bit."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _k3_frames(CPU, 3)
    calls = _k3_calls(monkeypatch)
    flows = None
    for k in range(2):
        flows = _k3_frame(frames, k, flows, params)
    calls.clear()
    with tracing.recording():
        replayed = _k3_frame(frames, 2, flows, params)
    levels = [s.counts for s in tracing.session() if s.name == "flow.level"]
    assert levels and all(c == {"flow.graph.replay": 1} for c in levels)
    replayed_calls = dict(calls)
    with fw.recorded() as rec:
        recorded = _k3_frame(frames, 2, flows, params)
    assert _recorded_k3(rec) == replayed_calls
    assert {site for site, _ in replayed_calls} == set(K3_SITES) and len(replayed_calls) > 2
    for site in K3_SITES:
        assert torch.equal(replayed[site], recorded[site])


def test_captured_launches_count_at_each_replay(fake_graphs, monkeypatch):
    """A hand kernel's launch inside a level (a stand-in that counts as
    ``cuda_build.launch`` does) counts as it runs in the capture's
    warm-up, is held back from the capture and kept with the graph, and
    counts once at each replay, in capture order, in its level's span:
    a replayed call's ``LAUNCHES`` and span counters equal the eager
    call's."""
    params = make_flow_params("pixflow_tpu")
    (a, b), = _frames(5, 1, 2, 80, 144)
    level_step = TPF._level_step

    def launching(src, flow, level, *args, **kw):
        cuda_build._count("stand_in_a", f"L{level}")
        out = level_step(src, flow, level, *args, **kw)
        cuda_build._count("stand_in_b", f"L{level}")
        return out

    monkeypatch.setattr(TPF, "_level_step", launching)
    n = len(TPF._pyramid_sizes(40, 72, params))

    def calls(k):
        counted = []
        for _ in range(k):
            cuda_build.reset_launch_counts()
            with tracing.recording():
                compute_flow(a, b, params, site="side_flow")
            counted.append((dict(cuda_build.LAUNCHES),
                            [s.counts for s in tracing.session() if s.name == "flow.level"]))
        return counted

    monkeypatch.setattr(TPF, "_graphable", lambda device: False)
    (eager,) = calls(1)
    monkeypatch.setattr(TPF, "_graphable", lambda device: True)
    _clear()
    capture, *replays = calls(3)
    cuda_build.reset_launch_counts()
    per_level = {"launches.stand_in_a": 1, "launches.stand_in_b": 1}
    assert eager == ({(k, f"L{i}"): 1 for i in range(n) for k in ("stand_in_a", "stand_in_b")},
                     [dict(per_level, **{"flow.graph.eager": 1})] * n)
    # the capture's call: its warm-up's launches, then its first replay's
    assert capture[0] == {k: 2 for k in eager[0]}
    assert capture[1] == [{"flow.graph.capture": 1, "launches.stand_in_a": 2,
                           "launches.stand_in_b": 2}] * n
    for launches, levels in replays:
        assert launches == eager[0]
        assert levels == [dict(per_level, **{"flow.graph.replay": 1})] * n
    (dg,) = TPF._DEVICE_GRAPHS.values()
    for key, rec in dg.graphs.items():
        assert list(rec.launches) == [("stand_in_a", f"L{key[5]}"), ("stand_in_b", f"L{key[5]}")]


def test_held_launches_count_only_when_replayed():
    """``cuda_build.held`` keeps the launches of its thread out of the
    account, in order, and puts back the list open before it;
    ``count_replayed`` counts each once, into the innermost span."""
    cuda_build.reset_launch_counts()
    with tracing.recording():
        with tracing.span("outer"):
            with cuda_build.held() as outer:
                cuda_build._count("k_a", "s")
                with cuda_build.held() as inner:
                    cuda_build._count("k_b", "s")
                cuda_build._count("k_c", "s")
            assert outer == [("k_a", "s"), ("k_c", "s")] and inner == [("k_b", "s")]
            assert not cuda_build.LAUNCHES
            cuda_build.count_replayed(outer + outer)
    (span,) = [s for s in tracing.session() if s.name == "outer"]
    assert span.counts == {"launches.k_a": 2, "launches.k_c": 2}
    assert dict(cuda_build.LAUNCHES) == {("k_a", "s"): 2, ("k_c", "s"): 2}
    cuda_build.reset_launch_counts()


def test_search_runs_in_its_own_graph(fake_graphs, monkeypatch):
    """pixflow_search_20: the hinted search runs inside a captured body of
    its own (the coarsest level's key and "search"), in front of the
    coarsest level's graph, and never eagerly or inside a level's body."""
    where = []
    real_capture, real_search, real_level = (
        TPF._capture, TPF._adjust_initial_flow, TPF._level_step)
    depth = {"graph": 0, "level": 0}

    def enter(name, fn):
        def tracked(*args, **kw):
            depth[name] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[name] -= 1
        return tracked

    monkeypatch.setattr(TPF, "_capture",
                        lambda step, out, dg: real_capture(enter("graph", step), out, dg))
    monkeypatch.setattr(TPF, "_level_step", enter("level", real_level))
    monkeypatch.setattr(TPF, "_adjust_initial_flow",
                        lambda *a: where.append(dict(depth)) or real_search(*a))
    params = make_flow_params("pixflow_search_20")
    a, b = _frames(4, 1, 2, 80, 144)[0]
    for _ in range(2):
        compute_flow(a, b, params, hint=torch.full((2,), HINT_LEFT, dtype=torch.int32))
    # the capture's warm-up, its first replay, the second call's replay
    assert where == [{"graph": 1, "level": 0}] * 3
    (dg,) = TPF._DEVICE_GRAPHS.values()
    searches = [k for k in dg.graphs if k[-1] == "search"]
    coarsest = len(TPF._pyramid_sizes(40, 72, params)) - 1
    assert len(searches) == 1 and searches[0][5] == coarsest
    assert searches[0][:-1] in dg.graphs


@pytest.mark.parametrize("hints", [[HINT_LEFT] * 2, [HINT_RIGHT] * 2, [HINT_DOWN] * 2,
                                   [HINT_DOWN, HINT_LEFT]],
                         ids=["left", "right", "down", "mixed"])
def test_graphed_search_equals_eager(fake_graphs, monkeypatch, hints):
    """The search's graph replayed with other hints than it was captured
    with: each call's search and flow equal the eager ones of its own
    hints bit for bit (the hints are read from the arena at every
    replay)."""
    params = make_flow_params("pixflow_search_20")
    a, b = _frames(9, 1, 2, 64, 112)[0]
    calls = [[TPF.HINT_UNKNOWN] * 2, hints, hints[::-1]]  # no box holds UNKNOWN
    searched = []
    real_search = TPF._search_step
    monkeypatch.setattr(TPF, "_search_step",
                        lambda *a, **kw: searched.append(real_search(*a, **kw)) or searched[-1])

    def run():
        searched.clear()
        flows = [(compute_flow(a, b, params, hint=torch.tensor(h, dtype=torch.int32)),)
                 for h in calls]
        return flows, [s.clone() for s in searched]

    (got, got_s), (want, want_s) = _eager_then_graphed(fake_graphs, monkeypatch, run)
    _assert_same(got, want)
    assert len(want_s) == 3 and len(got_s) == 4  # the capture's warm-up first
    _assert_same([got_s[1:]], [want_s])
    assert not want_s[0].any() and want_s[1].any()  # the hints change the search


def test_search_span_and_counters(fake_graphs, monkeypatch):
    """One ``flow.search`` span per flow call, inside the coarsest level's
    span, with the offsets tried and whether it was graphed; it counts
    the offsets and its capture, then replays; eager on the CPU."""
    params = make_flow_params("pixflow_search_20")
    (a, b), = _frames(5, 1, 2, 80, 144)
    n = len(TPF._pyramid_sizes(40, 72, params))
    tried = len(TPF._search_offsets(params)) - 1
    assert tried == 56

    def spans():
        with tracing.recording():
            prepare_pair_flows(a, b, params, site="side_flow")
            compute_flow(a, b, params, hint=torch.full((2,), HINT_DOWN, dtype=torch.int32),
                         site="side_flow")
        rec = tracing.session()
        by_id = {s.id: s for s in rec}
        searches = [s for s in rec if s.name == "flow.search"]
        assert len(searches) == 3
        for s in searches:
            level = by_id[s.parent]
            assert level.name == "flow.level" and level.attrs["level"] == n - 1
            assert s.attrs == dict(site="side_flow", h=level.attrs["h"], w=level.attrs["w"],
                                   offsets=tried, graphed=level.attrs["graphed"])
        return searches

    graphed = spans()
    assert all(s.attrs["graphed"] is True for s in graphed)
    assert [s.counts for s in graphed] == (
        [{"flow.search.offsets": tried, "flow.graph.capture": 1}]
        + [{"flow.search.offsets": tried, "flow.graph.replay": 1}] * 2)
    _clear()
    monkeypatch.setattr(TPF, "_graphable", lambda device: False)
    eager = spans()
    assert [s.counts for s in eager] == [
        {"flow.search.offsets": tried, "flow.graph.eager": 1}] * 3


def test_counters_capture_once_then_replay(fake_graphs):
    """The first call of a key captures each level, later calls replay;
    L->R and R->L share the key; every span says whether it was graphed."""
    params = make_flow_params("pixflow_tpu")
    (a, b), = _frames(5, 1, 2, 80, 144)
    with tracing.recording():
        prepare_pair_flows(a, b, params, site="side_flow")
        compute_flow(a, b, params, site="side_flow")
    levels = [s for s in tracing.session() if s.name == "flow.level"]
    n = len(TPF._pyramid_sizes(40, 72, params))
    assert n == 2
    assert len(levels) == 3 * n and all(s.attrs["graphed"] is True for s in levels)
    counts = [s.counts for s in levels]
    assert counts == [{"flow.graph.capture": 1}] * n + [{"flow.graph.replay": 1}] * 2 * n
    assert len(fake_graphs) == n


def test_calls_share_one_arena(fake_graphs):
    """The buffers of every key are views of one arena, sized for the
    temporal prior's inputs: a first frame, the later ones and a smaller
    call all fit the first call's arena."""
    params = make_flow_params("pixflow_tpu")
    big = _frames(7, 2, 2, 80, 144)
    small = _frames(8, 2, 4, 48, 40)
    _chain(big, params, True, HINT_LEFT, "side_flow")
    _chain(small, params, False, HINT_DOWN, "pole_flow")
    (dg,) = TPF._DEVICE_GRAPHS.values()
    assert len(dg.arenas) == 1 and len(dg.layouts) == 2
    base = dg.arenas[0].data_ptr()
    assert all(v[0].data_ptr() == base for v in dg.layouts.values())
    assert all((t.data_ptr() - base) % 512 == 0 for v in dg.layouts.values() for t in v)


def test_eager_levels_are_counted_on_the_cpu():
    _clear()
    (a, b), = _frames(6, 1, 2, 40, 72)
    with tracing.recording():
        compute_flow(a, b, make_flow_params("pixflow_tpu"))
    levels = [s for s in tracing.session() if s.name == "flow.level"]
    assert levels and all(s.attrs["graphed"] is False for s in levels)
    assert all(s.counts == {"flow.graph.eager": 1} for s in levels)
    assert not TPF._DEVICE_GRAPHS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def card(monkeypatch):
    """Runs a function eagerly on the card, then graphed."""
    _need_cuda()

    def both(run):
        monkeypatch.setattr(TPF, "_graphable", lambda device: False)
        _clear()
        want = run()
        monkeypatch.undo()
        _clear()
        got = run()
        torch.cuda.synchronize()
        return got, want

    yield both
    _clear()


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["pixflow_tpu", "pixflow_low", "pixflow_tpu_fast"])
def test_card_graphed_chains_equal_eager(card, preset):
    params = make_flow_params(preset)
    pair = _frames(0, 3, 14, 114, 166, CUDA)
    pole = _frames(1, 3, 4, 96, 80, CUDA)

    def run():
        return (_chain(pair, params, True, HINT_LEFT, "side_flow")
                + _chain(pole, params._replace(**POLE_HALOS), False, HINT_DOWN, "pole_flow"))

    got, want = card(run)
    _assert_same(got, want)


@pytest.mark.gpu
def test_card_counters_capture_once_then_replay(card):
    params = make_flow_params("pixflow_tpu")
    (a, b), = _frames(5, 1, 2, 96, 160, CUDA)
    _clear()
    with tracing.recording():
        for _ in range(3):
            compute_flow(a, b, params, site="side_flow")
    torch.cuda.synchronize()
    levels = [s for s in tracing.session() if s.name == "flow.level"]
    n = len(TPF._pyramid_sizes(48, 80, params))
    assert all(s.attrs["graphed"] is True for s in levels)
    assert [s.counts for s in levels] == (
        [{"flow.graph.capture": 1}] * n + [{"flow.graph.replay": 1}] * 2 * n)


def _counted_chain(frames, params, site):
    """The temporal chain of one ``compute_flow`` a frame (hint LEFT), with
    each frame's ``LAUNCHES`` and its ``flow.level`` spans' (level,
    counters)."""
    outs, launches, levels = [], [], []
    for k, (a, b) in enumerate(frames):
        kw = {}
        if k:
            kw = dict(prev_flow=outs[-1][0], prev_img0=frames[k - 1][0],
                      prev_img1=frames[k - 1][1])
        hint = torch.full((a.shape[0],), HINT_LEFT, dtype=torch.int32, device=a.device)
        cuda_build.reset_launch_counts()
        with tracing.recording():
            outs.append((compute_flow(a, b, params, hint=hint, use_temporal=k > 0, site=site,
                                      **kw),))
        launches.append(dict(cuda_build.LAUNCHES))
        levels.append([(s.attrs["level"], s.counts) for s in tracing.session()
                       if s.name == "flow.level"])
    return outs, launches, levels


@pytest.mark.gpu
def test_card_k3_launches_and_records_equal_eager(card):
    """Where K3 ranks the finest levels. With a record open the graphed
    run runs eagerly and launches and records K3 exactly as the eager run
    does. Without one, real graphs capture the K3 levels and replay them:
    a replayed frame counts the eager frame's launches, in the same level
    spans, and the flows equal the eager ones bit for bit."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _frames(2, 4, 4, 256, 384, CUDA)

    def run():
        cuda_build.reset_launch_counts()
        with fw.recorded() as rec:
            out = _chain(frames[:3], params, False, HINT_LEFT, "k3_site")
            torch.cuda.synchronize()
        record = {k: (v[3], tuple(v[0][3].shape)) for k, v in rec.items()}
        recorded = (out, record, dict(cuda_build.LAUNCHES))
        counted = _counted_chain(frames, params, "k3_site")
        torch.cuda.synchronize()
        return recorded, counted

    ((got, got_rec, got_n), (g_out, g_n, g_levels)), (
        (want, want_rec, want_n), (w_out, w_n, w_levels)) = card(run)
    _assert_same(got, want)
    assert want_n.get((fw.K3, "k3_site"), 0) > 0
    assert got_n == want_n and got_rec == want_rec
    _assert_same(g_out, w_out)
    sizes = TPF._pyramid_sizes(128, 192, params)
    assert sizes[0][0] * sizes[0][1] >= 16384 > sizes[1][0] * sizes[1][1]
    # frames 0 and 1 capture (the temporal prior makes new keys); 2 and 3 replay
    for k in (2, 3):
        assert g_n[k] == w_n[k] and g_n[k].get((fw.K3, "k3_site"), 0) > 0
        assert [lv for lv, _ in g_levels[k]] == [lv for lv, _ in w_levels[k]]
        for (_, got_c), (_, want_c) in zip(g_levels[k], w_levels[k]):
            assert got_c.pop("flow.graph.replay") == 1
            assert want_c.pop("flow.graph.eager") == 1
            assert got_c == want_c
        assert "launches.fused_window_offsets" in dict(g_levels[k])[0]
    assert np.isfinite(torch.stack([f[0] for f in g_out]).cpu().numpy()).all()


@pytest.mark.gpu
def test_card_record_equals_the_replayed_calls(monkeypatch):
    """Two K3 sites on the card. The K3 calls that the graphs of a
    replayed frame captured, per (site, offsets), equal the calls of the
    same frame run with the record open (eagerly); the launches counted at
    the replay (``count_replayed``) equal the recorded frame's, per site,
    and the record's calls; the flows are equal bit for bit."""
    _need_cuda()
    _clear()
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _k3_frames(CUDA, 3)
    captured = _k3_calls(monkeypatch, torch.cuda.is_current_stream_capturing)
    flows = _k3_frame(frames, 0, None, params)
    captured.clear()
    flows = _k3_frame(frames, 1, flows, params)  # captures the temporal levels
    capture_calls = dict(captured)

    def counted(record):
        cuda_build.reset_launch_counts()
        with tracing.recording(), record() as rec:
            out = _k3_frame(frames, 2, flows, params)
        torch.cuda.synchronize()
        launched = {site: cuda_build.launch_count(fw.K3, site) for site in K3_SITES}
        levels = [s.counts for s in tracing.session() if s.name == "flow.level"]
        return out, launched, levels, rec

    captured.clear()
    replayed, replay_n, replay_levels, _ = counted(_nothing)
    assert not captured
    assert replay_levels and all(c.get("flow.graph.replay") == 1 for c in replay_levels)
    recorded, record_n, record_levels, rec = counted(fw.recorded)
    assert all(c.get("flow.graph.eager") == 1 for c in record_levels)
    want = _recorded_k3(rec)
    assert capture_calls == want and {site for site, _ in want} == set(K3_SITES)
    assert replay_n == record_n == {site: sum(n for (s, _), n in want.items() if s == site)
                                    for site in K3_SITES}
    assert all(replay_n.values())
    for site in K3_SITES:
        assert torch.equal(replayed[site], recorded[site])
    _clear()


@pytest.mark.gpu
def test_card_k3_replay_copies_and_synchronises_nothing(card):
    """After its capture, a K3 level's span on the card holds its graph's
    launch and no copy or synchronise."""
    params = make_flow_params("pixflow_tpu_offsets")
    (a, b), = _frames(2, 1, 4, 256, 384, CUDA)
    _clear()
    compute_flow(a, b, params, site="k3_site")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            compute_flow(a, b, params, site="k3_site")
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e for e in events if e.name == "flow.level"),
                   key=lambda e: e.time_range.start)
    n = len(TPF._pyramid_sizes(128, 192, params))
    assert len(spans) == 2 * n
    k3 = [spans[n - 1].time_range, spans[2 * n - 1].time_range]  # each call's finest level

    def inside(e):
        return any(r.start <= e.time_range.start and e.time_range.end <= r.end for r in k3)

    names = [e.name for e in events if inside(e)]
    assert any("GraphLaunch" in n for n in names), names
    bad = [n for n in names if "ynchronize" in n or "emcpy" in n]
    assert bad == []


@pytest.mark.gpu
def test_card_graphed_search_equals_eager(card):
    """pixflow_search_20 on the card: both pair directions, the pole call
    and mixed hints, over a temporal chain; the graphed flows equal the
    eager ones bit for bit."""
    params = make_flow_params("pixflow_search_20")
    pair = _frames(0, 3, 14, 114, 166, CUDA)
    pole = _frames(1, 3, 4, 96, 80, CUDA)
    mixed = _frames(3, 2, 3, 96, 144, CUDA)

    def run():
        out = (_chain(pair, params, True, HINT_LEFT, "side_flow")
               + _chain(pole, params._replace(**POLE_HALOS), False, HINT_DOWN, "pole_flow"))
        hints = torch.tensor([HINT_LEFT, HINT_DOWN, HINT_RIGHT], dtype=torch.int32,
                             device=CUDA)
        for a, b in mixed:
            out.append((compute_flow(a, b, params, hint=hints, site="mixed"),
                        compute_flow(a, b, params, hint=hints.flip(0), site="mixed")))
        return out

    got, want = card(run)
    _assert_same(got, want)


@pytest.mark.gpu
def test_card_search_copies_and_synchronises_nothing(card):
    """After its capture, the search's span on the card holds its graph's
    launch and no copy or synchronise."""
    params = make_flow_params("pixflow_search_20")
    (a, b), = _frames(5, 1, 14, 114, 166, CUDA)
    _clear()
    hint = torch.full((14,), HINT_LEFT, dtype=torch.int32, device=CUDA)
    compute_flow(a, b, params, hint=hint, site="side_flow")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            compute_flow(a, b, params, hint=hint, site="side_flow")
        torch.cuda.synchronize()
    # the host's side: the spans and the runtime calls (the trace also
    # gives each span again on the device's timeline)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    searches = [e.time_range for e in events if e.name == "flow.search"]
    assert len(searches) == 2

    def inside(e):
        return any(r.start <= e.time_range.start and e.time_range.end <= r.end
                   for r in searches)

    names = [e.name for e in events if inside(e)]
    assert any("GraphLaunch" in n for n in names), names
    bad = [n for n in names if "ynchronize" in n or "emcpy" in n]
    assert bad == []
