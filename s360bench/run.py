"""One run of one benchmark cell of ``surround360_tpu_torch`` on the GPU.

    python3 -m s360bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration
(``configs/<config>.json``: the rig, the render preset, the ISP), a traffic
mix (``traffic/<mix>.json``, read by ``feed.py``), its per-layer metrics
(``metrics/<metric>.py``) and its limits of correctness
(``limits/<cell>.json``). A run:

1. loads the program (its CUDA kernels build into the checkout at first
   use) and makes the seed's frames on the device (``feed.py``);
2. warms up: frame 0 without a prior, then one frame as the window
   renders them;
3. renders one video stream in a closed loop for ``--seconds``: each frame
   is fed (8-bit frames converted as the CLI reads them; raw footage
   uploaded and put through the ISP per camera, as ``unpack`` does),
   rendered from the previous frame's temporal state (in a mix with
   ``"prior": false``, every frame without a prior, as frame 0 is),
   quantized to the 8-bit stereo equirect and copied to pinned host
   memory; a frame is launched once the previous frame's launches are
   issued, and the host then waits for the previous frame's delivery (one
   frame in flight);
4. with ``--trace 1``, times two frames' host enqueue, profiles three
   frames, and replays them to count their kernels' bytes;
5. checks frames against the plain reference (``check.py``) and prints
   the result as the last line of standard output.

Exit codes: 0 with a result; 2 without enough CUDA devices; 3 when the
program cannot be imported; 4 when a JAX module or the JAX package was
loaded. ``--control tf32`` runs the precision control (the reference in
the program's place, in TF32) instead of the program; it is for setting
the limits and is no part of a benchmark run.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "surround360_tpu")
HOST_FRAMES = 2  # traced run: untraced frames whose host enqueue is timed
TRACE_FRAMES = 3  # traced run: frames under the profiler
EARLY_CHECK = 3  # a window frame drawn from the first EARLY_CHECK is checked
BREAKDOWN_ROWS = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(BENCH_DIR, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer, limits)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"s360bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


class Stream:
    """A system's frames of one feed: inputs, render, delivery."""

    def __init__(self, system, feed, rig, device, prior: bool = True):
        import torch

        self.system, self.feed, self.device = system, feed, torch.device(device)
        self.side = [rig.ids.index(s) for s in rig.side_ids]
        self.top, self.bottom = rig.top_camera_index, rig.bottom_camera_index
        self.used = self.side + [self.top, self.bottom]
        self.cuda = self.device.type == "cuda"
        self.prior = prior  # False: every frame rendered as frame 0 is
        self.bufs: list = []
        self.enqueue_s: list = []

    def inputs(self, k: int, system=None):
        """(side, top, bottom) float32 RGBA of stream frame k, fed through
        ``system``'s ISP in raw footage (the stream's system by default)."""
        import torch

        from .feed import quantize8, to_rgba

        system = system or self.system
        feed = self.feed
        i = feed.index(k)
        if feed.kind == "rgb8":
            with span("s360bench.feed"):
                rgba = to_rgba(feed.pool[i][self.used].float() / 255.0)
        else:
            with span("s360bench.feed"):
                raw = feed.pool[i].to(self.device, non_blocking=True).float() / 65535.0
            with span("s360bench.isp"):
                rgb = [system.isp(raw[c], feed.isp[c]) for c in range(feed.cameras)]
                u8 = quantize8(torch.stack([rgb[c] for c in self.used]))
                rgba = to_rgba(u8.float() / 255.0)
        n = len(self.side)
        return rgba[:n], rgba[n], rgba[n + 1]

    def given(self, state):
        """The state a frame is rendered from after a frame whose new
        state is ``state``: that state, or None in a mix without the
        prior."""
        return state if self.prior else None

    def render(self, k: int, state):
        """Feed and render frame k (without a prior when ``state`` is
        None). Returns (outputs, new state)."""
        side, top, bottom = self.inputs(k)
        with span("s360bench.render"):
            t = time.perf_counter()
            if state is None:
                out = self.system.first(side, top, bottom)
            else:
                out = self.system.next(side, top, bottom, state)
            self.enqueue_s.append(time.perf_counter() - t)
        return out

    def deliver(self, k: int, outputs):
        """Quantize frame k's stereo equirect to 8 bits and start its copy
        to pinned host memory. Returns a handle for :meth:`wait`."""
        import torch

        from .feed import quantize8

        with span("s360bench.deliver"):
            q = quantize8(outputs["equirect"])
            if not self.bufs:
                self.bufs = [torch.empty(q.shape, dtype=torch.uint8, pin_memory=self.cuda)
                             for _ in range(2)]
            buf = self.bufs[k % 2]
            buf.copy_(q, non_blocking=self.cuda)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
        return buf, event

    def wait(self, handle, keep: bool = False):
        """Wait for a delivery; with ``keep`` return a copy of the frame."""
        buf, event = handle
        with span("s360bench.wait"):
            if event is not None:
                event.synchronize()
        return buf.clone() if keep else None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def to_host(state: dict, device) -> dict:
    """A copy of a finished temporal state in host memory, made on a side
    stream so that it waits for none of the frames queued behind it (None
    for None)."""
    import torch

    if state is None:
        return None
    if torch.device(device).type != "cuda":
        return {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        host = {k: v.to("cpu") for k, v in state.items()}
    side.synchronize()
    return host


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             make_system=None, reference=None) -> dict:
    """One run of ``cell``. ``make_system(config, device)`` builds the
    system under test (the program by default); ``reference`` is the
    check's reference (made by the check when None). Returns the result
    dict (without its ``device`` entry's name) and prints nothing on
    stdout."""
    import numpy as np
    import torch

    from .feed import Feed
    from .reference.rig import make_ring_rig

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if make_system is None:
        from .program import Program as make_system
    system = make_system(cell.config, dev)
    from .reference.system import tuples

    feed_rig = make_ring_rig(**{k: tuples(v) for k, v in cell.config["rig"].items()})
    if list(feed_rig.ids) != list(system.rig.ids):
        raise RuntimeError("the program's rig is not the configuration's")
    feed = Feed(cell.config, cell.traffic, seed, feed_rig, dev)
    stream = Stream(system, feed, feed_rig, dev, prior=bool(cell.traffic.get("prior", True)))
    rng = np.random.default_rng([seed, 2])

    # warm-up: frame 0 without a prior, then one frame as the window's
    out0, st0 = stream.render(0, None)
    frame0 = stream.wait(stream.deliver(0, out0), keep=True)
    del out0
    out1, st1 = stream.render(1, stream.given(st0))
    stream.wait(stream.deliver(1, out1))
    del out1
    _sync(dev)
    setup_s = process_age_s()
    stream.enqueue_s.clear()

    # (frame, state in, state out, delivered frame); the states of checked
    # frames before the last wait in host memory, so that holding them
    # leaves the device's peak alone
    checks = [(0, None, to_host(st0, dev), frame0)]
    early = 2 + int(rng.integers(0, EARLY_CHECK))
    state, k = st1, 2
    del st0
    result: dict = {}
    data = None
    if not trace:
        frames, pending, prev = 0, None, None
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            given = stream.given(state)
            out, new = stream.render(k, given)
            handle = stream.deliver(k, out)
            del out
            if pending is not None:
                kept = stream.wait(pending[1], keep=pending[0] == early)
                frames += 1
                if kept is not None:
                    checks.append((early, to_host(early_in, dev), to_host(early_out, dev), kept))
                    early_in = early_out = None
            if k == early:
                early_in, early_out = given, new
            pending = (k, handle)
            prev, state = given, new
            k += 1
        last = stream.wait(pending[1], keep=True)
        frames += 1
        window_s = time.perf_counter() - t_start
        if pending[0] == early:
            checks.append((early, early_in, early_out, last))
        else:
            checks.append((pending[0], prev, state, last))
        early_in = early_out = None
        attempted = frames
        result["render_fps"] = frames / window_s
    else:
        data, state, k, traced = _traced_window(stream, state, k, checks, dev)
        attempted = traced
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if not trace:
        result["peak_mem_gib"] = peak / 2**30
        result["setup_s"] = setup_s

    # the program's state is freed before the reference runs: only the
    # checked frames' states and deliveries are kept
    prev = state = new = None
    stream.system = system = None
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
    from .check import judge

    numbers, failed, readings = judge(cell, stream, checks, dev, reference)
    return dict(metrics=result, peak=peak, attempted=attempted, failed=failed,
                numbers=numbers, readings=readings, data=data)


def _traced_window(stream, state, k, checks, dev):
    """Two frames timed on the host clock, then TRACE_FRAMES frames under
    the profiler, then those frames replayed with the program's per-call
    record to count their kernels' bytes. Returns (TraceData, state, next
    frame, traced frames)."""
    import torch

    from .bounds import call_bytes
    from .program import KERNEL_TRACE_NAMES, kernel_calls
    from .trace import read_chrome_trace

    for _ in range(HOST_FRAMES):
        out, state = stream.render(k, stream.given(state))
        stream.wait(stream.deliver(k, out))
        k += 1
    host_s = list(stream.enqueue_s)
    _sync(dev)
    first, start_state = k, state
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with span("s360bench.window"):
            pending = None
            for _ in range(TRACE_FRAMES):
                given = stream.given(state)
                out, new = stream.render(k, given)
                handle = stream.deliver(k, out)
                if pending is not None:
                    stream.wait(pending)
                pending, prev, state = handle, given, new
                k += 1
            last = stream.wait(pending, keep=True)
            _sync(dev)
    checks.append((k - 1, prev, state, last))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        data = read_chrome_trace(path, TRACE_FRAMES)
    data.host_enqueue_s = host_s
    data.kernel_names = dict(KERNEL_TRACE_NAMES)

    # replay the traced frames from the same state for the per-call bytes
    calls: list = []
    totals: dict = {}
    with kernel_calls(calls):
        st = start_state
        for j in range(first, k):
            out, st = stream.render(j, stream.given(st))
            del out
            for kernel, args, kw in calls:
                totals[kernel] = totals.get(kernel, 0) + call_bytes(args, kw)
            calls.clear()
    data.call_bytes = totals
    return data, state, k, TRACE_FRAMES


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, run: dict, trace: bool, device_info: dict) -> dict:
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in run["metrics"]:
                metrics[m["name"]] = {"value": run["metrics"][m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run["data"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = run["numbers"]
    line = {
        "correct": all(v["value"] <= v["limit"] for v in numbers.values()),
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        data = run["data"]
        line["device"].update(busy_s=data.busy_s, window_s=data.window_s)
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in data.device_ops[:BREAKDOWN_ROWS]],
            "idle_gaps": [[n, s] for n, s in data.idle_gaps[:BREAKDOWN_ROWS]],
        }
    line["checks"] = numbers
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "tf32"), default="none",
                   help="tf32: the reference in TF32 in the program's place")
    args = p.parse_args(argv)

    cell = resolve(args.workload)
    os.makedirs(CACHE_DIR, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"s360bench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    make_system = None
    if args.control == "tf32":
        from .reference.system import Reference

        make_system = lambda config, device: Reference(config, device, tf32=True)  # noqa: E731
    else:
        try:
            import surround360_tpu_torch  # noqa: F401
        except ImportError as e:
            log(f"s360bench: the program surround360_tpu_torch cannot be imported: {e}")
            return 3
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", make_system)
    bad = _forbidden_modules()
    if bad:
        log(f"s360bench: modules of JAX or the JAX package were loaded: {bad}")
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(run["peak"])}
    line = result_line(cell, run, bool(args.trace), device_info)
    for name, v in line["checks"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
