"""CUDA graphs of the flow's pyramid levels (``flow/pixflow.py``).

On the CPU: which levels are captured (a function of the device and the
sampler's route), the key, the device constants built once, and the
graphed level loop itself, run with a stand-in for the capture that
replays a level's body on the same persistent buffers, so the loading of
inputs, the chaining of outputs, the search's own graph and the counters
are held to the eager flow bit for bit. ``gpu``-marked: the same on the
card with real graphs, and the search's span free of copies and
synchronises. No JAX here, so the file runs on the card with
``--noconftest``.
"""

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
from surround360_tpu_torch.ops.window_sampler import make_window_sampler
from surround360_tpu_torch.utils import tracing
from surround360_tpu_torch.views.novel_view import prepare_pair_flows

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
POLE_HALOS = dict(window_halo_y_frac=0.30, window_halo_x_frac=0.10)


def _clear():
    TPF._level_graphed.cache_clear()
    TPF._DEVICE_GRAPHS.clear()


@pytest.fixture
def fake_graphs(monkeypatch):
    """Levels on the CPU taken through the graphed loop: "capture" runs
    the level once as the warm-up and returns a graph whose replay runs it
    again on the same buffers. Yields the list of those graphs."""
    made = []

    class Replayed:
        def __init__(self, step, out):
            self.step, self.out, self.replays = step, out, 0

        def replay(self):
            self.replays += 1
            self.out.copy_(self.step())

    def capture(step, out, dg):
        step()
        made.append(Replayed(step, out))
        return made[-1]

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


@pytest.mark.parametrize("preset", ["pixflow_tpu", "pixflow_tpu_offsets", "pixflow_tpu_fast",
                                    "pixflow_low", "pixflow_search_20"])
@pytest.mark.parametrize("B,H,W", [(2, 24, 40), (1, 64, 128), (2, 128, 160), (14, 113, 165)])
def test_capture_predicate_is_the_samplers_route(preset, B, H, W):
    """A level is captured exactly where it is on a CUDA device and every
    sampler it builds takes the plain route; the CPU never captures."""
    params = make_flow_params(preset)
    probes = TPF._PROBES if params.use_probe_candidates else ()
    for is_finest in (False, True):
        lv = TPF._level_plan(B, H, W, params, is_finest)
        kernel = False
        if params.offset_ranking and not lv.use_residual:
            src = torch.zeros((B, 2, H, W))
            kernel = any(
                make_window_sampler(
                    src, (H, W), lv.halo_y, lv.halo_x, "bilinear", "clamp",
                    tr=TPF._OFFSET_RANK_TR, tc=TPF._OFFSET_RANK_TC,
                    precision=params.error_sampler_precision,
                    offsets=TPF._rank_offsets(int(d), probes),
                ).backend == "kernel"
                for d in lv.offsets)
        assert TPF._level_uses_kernel(B, H, W, params, is_finest) is kernel
        assert TPF._level_graphed(CUDA, B, H, W, params, is_finest) is (not kernel)
        assert TPF._level_graphed(CPU, B, H, W, params, is_finest) is False


def test_capture_predicate_splits_the_offsets_pyramid():
    """pixflow_tpu_offsets: levels of 16384 px or more rank through K3 and
    stay eager; the coarser ones are captured."""
    params = make_flow_params("pixflow_tpu_offsets")
    sizes = TPF._pyramid_sizes(128, 256, params)
    graphed = [TPF._level_graphed(CUDA, 2, h, w, params, i == 0)
               for i, (h, w) in enumerate(sizes)]
    assert graphed == [h * w < 16384 for h, w in sizes] == [False, True, True, True]
    plain = params._replace(offset_ranking=False)
    assert all(TPF._level_graphed(CUDA, 2, h, w, plain, i == 0)
               for i, (h, w) in enumerate(sizes))


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


def test_graphed_loop_keeps_k3_levels_eager(fake_graphs, monkeypatch):
    """pixflow_tpu_offsets with a K3 finest level: that level runs eagerly
    on the graphed levels' output, its launches and records are the eager
    run's, and the flows are equal."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _frames(2, 2, 1, 256, 256)

    def run():
        with fw.recorded() as rec:
            out = _chain(frames, params, False, HINT_LEFT, "k3_site")
        return out, {k: (v[3], v[0][3].shape) for k, v in rec.items()}

    (got, got_rec), (want, want_rec) = _eager_then_graphed(fake_graphs, monkeypatch, run)
    _assert_same(got, want)
    assert want_rec and got_rec == want_rec
    assert all(k[0] == fw.K3 for k in want_rec)


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


@pytest.mark.gpu
def test_card_k3_launches_and_records_equal_eager(card):
    """Where K3 ranks the finest levels, the graphed run launches and
    records K3 exactly as the eager run does, with equal flows."""
    params = make_flow_params("pixflow_tpu_offsets")
    frames = _frames(2, 3, 4, 256, 384, CUDA)

    def run():
        cuda_build.reset_launch_counts()
        with fw.recorded() as rec:
            out = _chain(frames, params, False, HINT_LEFT, "k3_site")
            torch.cuda.synchronize()
        record = {k: (v[3], tuple(v[0][3].shape)) for k, v in rec.items()}
        return out, record, dict(cuda_build.LAUNCHES)

    (got, got_rec, got_n), (want, want_rec, want_n) = card(run)
    _assert_same(got, want)
    assert want_n.get((fw.K3, "k3_site"), 0) > 0
    assert got_n == want_n and got_rec == want_rec
    graphed = [TPF._level_graphed(CUDA, 4, h, w, params, i == 0)
               for i, (h, w) in enumerate(TPF._pyramid_sizes(128, 192, params))]
    assert True in graphed and False in graphed
    assert np.isfinite(torch.stack([f[0] for f in got]).cpu().numpy()).all()


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
