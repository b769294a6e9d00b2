"""Package boundary of the PyTorch port: no JAX, no toolchain at import,
and no silent fallback from the CUDA kernel to its twin."""

import contextlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from surround360_tpu_torch import cuda_build
from surround360_tpu_torch.ops import fused_window as fw

SLICE_MODULES = [
    "surround360_tpu_torch",
    "surround360_tpu_torch.cuda_build",
    "surround360_tpu_torch.utils.math_util",
    "surround360_tpu_torch.utils.tracing",
    "surround360_tpu_torch.geometry.camera",
    "surround360_tpu_torch.geometry.rig",
    "surround360_tpu_torch.ops.warp",
    "surround360_tpu_torch.capture.simulator",
    "surround360_tpu_torch.capture.daemon",
    "surround360_tpu_torch.ops.resize",
    "surround360_tpu_torch.ops.filters",
    "surround360_tpu_torch.ops.compositing",
    "surround360_tpu_torch.ops.fused_window",
    "surround360_tpu_torch.ops.remap",
    "surround360_tpu_torch.ops.window_sampler",
    "surround360_tpu_torch.flow.pixflow",
    "surround360_tpu_torch.flow.visualization",
    "surround360_tpu_torch.views.novel_view",
    "surround360_tpu_torch.render.panorama",
    "surround360_tpu_torch.render.pole",
    "surround360_tpu_torch.render.profiling",
    "surround360_tpu_torch.render.preview",
    "surround360_tpu_torch.native",
    "surround360_tpu_torch.isp",
    "surround360_tpu_torch.isp.raw",
    "surround360_tpu_torch.isp.footage",
    "surround360_tpu_torch.isp.dng",
    "surround360_tpu_torch.isp.demosaic",
    "surround360_tpu_torch.isp.pipeline",
    "surround360_tpu_torch.cli.common",
    "surround360_tpu_torch.cli.tiff",
    "surround360_tpu_torch.cli.jpeg",
    "surround360_tpu_torch.cli.preview",
    "surround360_tpu_torch.cli.compare",
    "surround360_tpu_torch.cli.render_video",
    "surround360_tpu_torch.cli.unpack",
    "surround360_tpu_torch.cli.raw2rgb",
    "surround360_tpu_torch.cli.dng_helper",
    "surround360_tpu_torch.cli.run_all",
    "surround360_tpu_torch.cli.calibrate",
    "surround360_tpu_torch.calib",
    "surround360_tpu_torch.calib.geometric",
    "surround360_tpu_torch.calib.orb",
    "surround360_tpu_torch.calib.matches",
    "surround360_tpu_torch.calib.vignetting",
    "surround360_tpu_torch.calib.color",
    "surround360_tpu_torch.parallel",
    "surround360_tpu_torch.parallel.mesh",
    "surround360_tpu_torch.benchmarks",
    "surround360_tpu_torch.benchmarks.probe_common",
    "surround360_tpu_torch.benchmarks.kernel_step_cost",
    "surround360_tpu_torch.benchmarks.kernel_body_cost",
    "surround360_tpu_torch.benchmarks.profile_stages",
    "surround360_tpu_torch.benchmarks.preset_table",
    "surround360_tpu_torch.benchmarks.preset_quality",
    "surround360_tpu_torch.benchmarks.flow_quality",
    "surround360_tpu_torch.benchmarks.trace_grid_economics",
    "surround360_tpu_torch.bench",
    "surround360_tpu_torch.graft_entry",
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )


def test_port_imports_no_jax():
    """Importing every module of the port brings in neither jax, cv2, PIL,
    nor any module of the JAX package or its benchmark folder, builds
    nothing (no native library, no kernel), and the list covers every
    module file of the package."""
    pkg = os.path.join(REPO, "surround360_tpu_torch")
    on_disk = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
                on_disk.add(rel.replace(os.sep, ".").removesuffix(".__init__"))
    listed = set(SLICE_MODULES)
    # sub-packages are imported with their modules
    assert {m for m in on_disk if m not in listed and not any(
        l.startswith(m + ".") for l in listed)} == set()
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'cv2', 'PIL', 'benchmarks') or "
        "m.startswith(('jax.', 'jaxlib', 'cv2.', 'PIL.', 'benchmarks.', 'surround360_tpu.')) "
        "or m == 'surround360_tpu')\n"
        "print('LEAKED', bad)\n"
        "import surround360_tpu_torch.native as native\n"
        "import surround360_tpu_torch.cuda_build as cuda_build\n"
        "assert native._lib is None and not cuda_build._LIBS\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_module_imports_without_toolchain(tmp_path):
    """No nvcc on PATH, no CUDA_HOME, no triton: the kernel module still
    imports (the toolchain is only looked up when a kernel launches)."""
    code = (
        "import sys\n"
        "import surround360_tpu_torch.ops.fused_window\n"
        "import surround360_tpu_torch.cuda_build as cuda_build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not cuda_build._LIBS\n"
    )
    proc = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr


def test_color_and_mesh_entry_points_default_to_cuda(monkeypatch):
    """The colour calibration, the mesh, the bench and the root entry's
    counterpart run on the card unless the caller asks for the CPU: the
    library functions' device defaults, calibrate color's and the bench's
    --device, and make_render_mesh() over the visible CUDA devices, which
    raises without one."""
    import inspect

    from surround360_tpu_torch import bench, graft_entry
    from surround360_tpu_torch.calib import color
    from surround360_tpu_torch.cli import calibrate
    from surround360_tpu_torch.parallel import make_render_mesh

    for fn in (color.detect_color_chart, color.solve_isp_color_params,
               graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(bench, "_install_watchdog", lambda seconds: None)
    monkeypatch.setattr(bench, "_preset_bench", lambda preset, device: (1.0, str(device)))
    if torch.cuda.is_available():
        bench.main([])
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main([])
    seen = {}
    monkeypatch.setattr(calibrate, "run_color", lambda args: seen.update(vars(args)))
    calibrate.main(["color", "--charts_dir", "charts", "--output_isp_dir", "isp"])
    assert seen["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_render_mesh()


def test_every_entry_point_leaves_tf32_off():
    """Starting from torch's defaults (cuDNN may run float32 convolutions
    in TF32), resolve_device and the public callers of every convolution
    and float32 product site each leave both TF32 flags off: the resize's
    two convolution paths, the ORB matcher's Hamming product, the
    vignetting blur, the ISP, render_frame and the mesh's step."""
    code = """
import numpy as np, torch
from torch.backends import cuda, cudnn
assert cudnn.allow_tf32, "torch's default"
torch.set_num_threads(1)
from surround360_tpu_torch.calib.orb import orb_match
from surround360_tpu_torch.calib.vignetting import acquire_vignetting_samples
from surround360_tpu_torch.cli.common import resolve_device
from surround360_tpu_torch.isp.pipeline import IspConfig, isp_process
from surround360_tpu_torch.ops.filters import sharpen_iir
from surround360_tpu_torch.ops.resize import gaussian_blur, resize_cubic
from surround360_tpu_torch.graft_entry import _make_inputs
from surround360_tpu_torch.parallel.mesh import make_render_mesh, sharded_render_step
from surround360_tpu_torch.render.panorama import render_frame
rng = np.random.default_rng(0)
ctx, side, top, bottom = _make_inputs(0.03125, 140, 70, torch.device("cpu"))
step = sharded_render_step(ctx, make_render_mesh([torch.device("cpu")]))[0]
img = torch.from_numpy(rng.random((1, 8, 2600), dtype=np.float32))
calls = {
    "resolve_device": lambda: resolve_device("cpu"),
    "gaussian_blur": lambda: gaussian_blur(img, 2.0),
    "sharpen_iir": lambda: sharpen_iir(img, 1.25),
    "resize_cubic": lambda: resize_cubic(img[..., :1300], (8, 2600)),
    "orb": lambda: orb_match(*rng.random((2, 96, 128)).astype(np.float32), device="cpu"),
    "vignetting": lambda: acquire_vignetting_samples([rng.random((64, 64))], device="cpu"),
    "isp": lambda: isp_process(torch.rand(32, 32), IspConfig()),
    "render_frame": lambda: render_frame(ctx, side, top, bottom),
    "mesh": lambda: step(side[None], top[None], bottom[None], None),
}
for name, call in calls.items():
    cuda.matmul.allow_tf32 = cudnn.allow_tf32 = True
    call()
    assert not cuda.matmul.allow_tf32 and not cudnn.allow_tf32, name
print("OK", len(calls))
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr


class _FakeCudaTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's
    CUDA branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _small_inputs():
    rng = np.random.default_rng(0)
    padded = rng.random((1, 2, 16, 32), dtype=np.float32)
    sy = np.zeros((2, 1), np.int32)
    sx = np.zeros((2, 1), np.int32)
    xt = rng.uniform(0, 30, (2, 1, 8)).astype(np.float32)
    yt = rng.uniform(0, 14, (2, 1, 8)).astype(np.float32)
    kw = dict(bh=16, bw=32, pad_y=0, pad_x=0, n_y=16, n_x=32)
    return [torch.from_numpy(a) for a in (padded, sy, sx, xt, yt)], kw


def _small_folded_inputs():
    arrays, kw = _small_inputs()
    arrays[1], arrays[2] = arrays[1][:, 0].contiguous(), arrays[2][:, 0].contiguous()
    return arrays, dict(kw, interpolation="bilinear", border="clamp")


# every hand-kernel wrapper: K1, K2, K3, K4 at its three sites, K5
HAND_KERNELS = ["K1", "K2", "K3", "K4-variant", "K4-dyn", "K4-dma", "K5"]


def _hand_kernel_calls():
    """One call of each wrapper of :data:`HAND_KERNELS` on small CPU
    inputs: {case: (call, arguments)}."""
    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS

    arrays, kw = _small_inputs()
    folded, fkw = _small_folded_inputs()
    k3 = dict(offsets=((0, 0), (0, 2), (-2, 0)), off_my=2, off_mx=2)
    calls = {
        "K1": (lambda *a: fw.fused_window_sample(*a, **kw, site="wide"), arrays),
        "K2": (lambda *a: fw.fused_window_sample_folded(*a, **fkw), folded),
        "K3": (lambda *a: fw.fused_window_sample_folded(*a, **fkw, **k3), folded),
    }
    rng = np.random.default_rng(0)
    for case, name in (("K4-variant", "dots_x5"), ("K4-dyn", "lead8_unrolled"),
                       ("K4-dma", "tent_dots_dyn_dma_x5")):
        calls[case] = (lambda *a, name=name: KS.step_cost(name, *a),
                       KS.make_inputs(rng, name, 2, "cpu"))
    calls["K5"] = (lambda *a: KB.body_cost("full_dma", *a),
                   KB.make_inputs(rng, "full_dma", 2, "cpu"))
    return calls


def _fake_cuda(args):
    return [None if a is None else a.as_subclass(_FakeCudaTensor) for a in args]


def _without_toolchain(monkeypatch, tmp_path):
    """No nvcc, no built library, and every twin raising: a wrapper on a
    CUDA tensor can only launch its kernel or raise."""
    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS

    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))

    def no_twin(*a, **k):
        raise AssertionError("fell back to the plain twin")

    for mod, names in ((fw, ("fused_window_sample_reference",
                             "fused_window_sample_folded_reference", "window_gather")),
                       (KS, ("step_cost_plain", "_plain_chunk")),
                       (KB, ("body_cost_plain", "_plain_chunk"))):
        for name in names:
            monkeypatch.setattr(mod, name, no_twin)


@pytest.mark.parametrize("case", HAND_KERNELS)
def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path, case):
    """A CUDA tensor must launch the hand kernel or raise: without nvcc and
    without a built library each wrapper raises, its twin never runs, and
    no launch is counted."""
    _without_toolchain(monkeypatch, tmp_path)
    call, args = _hand_kernel_calls()[case]
    launches = dict(cuda_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call(*_fake_cuda(args))
    assert dict(cuda_build.LAUNCHES) == launches


@pytest.mark.parametrize("case", HAND_KERNELS)
def test_launch_error_raises_and_never_takes_the_twin(monkeypatch, tmp_path, case):
    """A launch the card refuses (cudaErrorInvalidValue, 1: e.g. a window
    row that a block's shared memory cannot hold) raises from each wrapper:
    no twin runs in its place and no launch is counted."""
    _without_toolchain(monkeypatch, tmp_path)
    seen = []

    def refuse(*args):
        seen.append(args)
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(cuda_build, "entry", lambda source, name, argtypes: refuse)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: real_empty(*a, **k))
    call, args = _hand_kernel_calls()[case]
    launches = dict(cuda_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 1"):
        call(*_fake_cuda(args))
    assert len(seen) == 1 and seen[0][-1] == 0  # the stream, last
    assert dict(cuda_build.LAUNCHES) == launches


def test_other_devices_raise(monkeypatch):
    arrays, kw = _small_inputs()
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="unsupported device"):
        fw.fused_window_sample(*meta, **kw)


def test_cpu_tensor_uses_twin_and_counts_no_launch():
    arrays, kw = _small_inputs()
    launches = dict(cuda_build.LAUNCHES)
    out = fw.fused_window_sample(*arrays, **kw, site="test")
    ref = fw.fused_window_sample_reference(*arrays, **kw)
    assert out.shape == (2, 1, 2, 8)
    assert torch.equal(out, ref)
    folded, fkw = _small_folded_inputs()
    offs = ((0, 0), (1, -1))
    out = fw.fused_window_sample_folded(*folded, **fkw, offsets=offs, off_my=1,
                                        off_mx=1, site="test")
    assert out.shape == (2, 1, 2, 2, 8)
    assert dict(cuda_build.LAUNCHES) == launches


def test_recorded_keeps_the_largest_call_and_restores_the_earlier_record():
    """recorded() keeps per (kernel, site, offsets) the call with the most
    samples and the call count; a record opened inside it sees only its own
    calls, and on its exit, by an exception too, the outer one is back."""
    arrays, kw = _small_inputs()
    fewer = arrays[:3] + [a[..., :4].contiguous() for a in arrays[3:]]
    with fw.recorded() as outer:
        fw.fused_window_sample(*arrays, **kw, site="a")
        with pytest.raises(RuntimeError, match="inside"):
            with fw.recorded() as inner:
                fw.fused_window_sample(*arrays, **kw, site="b")
                raise RuntimeError("inside")
        fw.fused_window_sample(*fewer, **kw, site="a")
    assert list(inner) == [(fw.K1, "b", None)]
    assert list(outer) == [(fw.K1, "a", None)]
    args, got_kw, out, calls = outer[(fw.K1, "a", None)]
    assert calls == 2 and args[3].shape == (2, 1, 8) and out.shape == (2, 1, 2, 8)
    assert got_kw == dict(kw, interpolation="bicubic", border="constant", base_bw=None)
    fw.fused_window_sample(*arrays, **kw, site="after")
    assert list(outer) == [(fw.K1, "a", None)] and fw._RECORD is None


def test_wrapper_validates_inputs():
    arrays, kw = _small_inputs()
    bad = list(arrays)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="sy must be"):
        fw.fused_window_sample(*bad, **kw)
    with pytest.raises(ValueError, match="unknown interpolation"):
        fw.fused_window_sample(*arrays, **kw, interpolation="nearest")
    folded, fkw = _small_folded_inputs()
    with pytest.raises(ValueError, match="sy must be T int32"):
        fw.fused_window_sample_folded(*arrays, **fkw)
    with pytest.raises(ValueError, match="bilinear only"):
        fw.fused_window_sample_folded(*folded, **dict(fkw, interpolation="bicubic"),
                                      offsets=((0, 0),))
    with pytest.raises(ValueError, match="exceeds its margin"):
        fw.fused_window_sample_folded(*folded, **fkw, offsets=((0, 3),), off_mx=2)


@pytest.mark.gpu
def test_kernel_matches_twin_on_gpu():
    """The CUDA kernel against its twin on the card: every interpolation x
    border mode, tight and plain windows, origins at the array edges, NaN
    and far coordinates, a sample count that is no multiple of 32. Max-abs
    2e-5: identical f32 tap math, only FMA contraction differs. Runs on a
    GPU machine (see README); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    L, C, Hp, Wp, T, P = 3, 4, 48, 300, 5, 77
    padded = rng.random((L, C, Hp, Wp), dtype=np.float32)
    for interp in ("bicubic", "bilinear"):
        for border in ("constant", "clamp"):
            for base_bw in (None, 61):
                bh, bw = 24, 128
                wx = base_bw or bw
                sy = rng.integers(0, Hp - bh + 1, (T, L)).astype(np.int32)
                sx = rng.integers(0, Wp - wx + 1, (T, L)).astype(np.int32)
                sy[0], sx[0] = 0, 0
                sy[1], sx[1] = Hp - bh, Wp - wx
                xt = (sx[..., None] + rng.uniform(-5, wx + 5, (T, L, P))).astype(np.float32)
                yt = (sy[..., None] + rng.uniform(-5, bh + 5, (T, L, P))).astype(np.float32)
                xt[2, :, :3] = [np.nan, 1e6, -1e6]
                yt[3, :, :3] = [-1e6, np.nan, 1e6]
                dev = [torch.from_numpy(a).cuda() for a in (padded, sy, sx, xt, yt)]
                kw = dict(bh=bh, bw=bw, pad_y=4, pad_x=6, n_y=Hp - 8, n_x=Wp - 12,
                          interpolation=interp, border=border, base_bw=base_bw)
                got = fw.fused_window_sample(*dev, **kw)
                torch.cuda.synchronize()
                want = fw.fused_window_sample_reference(*dev, **kw)
                assert bool(torch.isfinite(got).all())
                assert float((got - want).abs().max()) <= 2e-5, (interp, border, base_bw)


def _folded_gpu_cases(rng):
    """K2 (every interpolation x border, plain and tight windows) and K3
    (the flow's offset sets at d = 8, 4, 2, 1, both borders) on small
    shapes, with origins at the array edges, NaN / far coordinates and a
    sample count that is no multiple of 32."""
    L, C, Hp, Wp, T, P = 3, 2, 64, 400, 5, 77
    padded = rng.random((L, C, Hp, Wp), dtype=np.float32)

    def coords(sy, sx, bh, wx):
        xt = (sx[:, None, None] + rng.uniform(-5, wx + 5, (T, L, P))).astype(np.float32)
        yt = (sy[:, None, None] + rng.uniform(-5, bh + 5, (T, L, P))).astype(np.float32)
        xt[2, :, :3] = [np.nan, 1e6, -1e6]
        yt[3, :, :3] = [-1e6, np.nan, 1e6]
        return xt, yt

    base = dict(pad_y=4, pad_x=6, n_y=Hp - 12, n_x=Wp - 20)
    for interp in ("bicubic", "bilinear"):
        for border in ("constant", "clamp"):
            for bw, base_bw in ((128, None), (256, 61)):
                bh, wx = 24, base_bw or bw
                sy = rng.integers(0, Hp - bh + 1, T).astype(np.int32)
                sx = rng.integers(0, Wp - wx + 1, T).astype(np.int32)
                sy[0], sx[0], sy[1], sx[1] = 0, 0, Hp - bh, Wp - wx
                kw = dict(base, bh=bh, bw=bw, interpolation=interp, border=border,
                          base_bw=base_bw)
                yield (padded, sy, sx, *coords(sy, sx, bh, wx)), kw
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
    for d in (8, 4, 2, 1):
        offs = ((0, 0),) + tuple((py * d, px * d) for py, px in dirs)
        for border in ("constant", "clamp"):
            bh, bw = 24 + 2 * d, 128 + (128 if d > 4 else 0)
            sy = rng.integers(0, Hp - bh + 1, T).astype(np.int32)
            sx = rng.integers(0, (Wp - bw) // 128 + 1, T).astype(np.int32) * 128
            sy[0], sx[0] = 0, 0
            kw = dict(base, bh=bh, bw=bw, interpolation="bilinear", border=border,
                      offsets=offs, off_my=d, off_mx=d)
            yield (padded, sy, sx, *coords(sy, sx, bh, bw)), kw


@pytest.mark.gpu
def test_folded_kernels_match_twin_on_gpu():
    """K2 and K3 against their twin on the card, max-abs 2e-5 (same f32
    tap math). Runs on a GPU machine (see README); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    for arrays, kw in _folded_gpu_cases(rng):
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        got = fw.fused_window_sample_folded(*dev, **kw)
        torch.cuda.synchronize()
        want = fw.fused_window_sample_folded_reference(*dev, **kw)
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 2e-5, kw


def test_probe_wrappers_raise_on_other_devices():
    for call, args in _hand_kernel_calls().values():
        with pytest.raises(ValueError, match="unsupported device"):
            call(*[None if a is None else a.to("meta") for a in args])


def _gpu_probes():
    """The probe modules on the card, TF32 off (their twins' products are
    float32 torch.matmul); skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from surround360_tpu_torch.benchmarks import kernel_body_cost as KB
    from surround360_tpu_torch.benchmarks import kernel_step_cost as KS

    return torch.device("cuda", 0), KS, KB


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["kernel_step_cost_variant", "kernel_step_cost_dyn",
                                  "kernel_step_cost_dma"])
def test_step_cost_kernel_matches_twin_on_gpu(site):
    """K4 at each of its three sites against the twin on the card: within
    1e-5 of the output's max |value| (3xTF32 against float32, sums in
    another order)."""
    dev, KS, _ = _gpu_probes()
    rng = np.random.default_rng(4)
    for name, (s, _) in KS.VARIANTS.items():
        if s != site:
            continue
        args = KS.make_inputs(rng, name, 5, dev)
        got = KS.step_cost(name, *args)
        torch.cuda.synchronize()
        want = KS.step_cost_plain(name, *args)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)


@pytest.mark.gpu
def test_body_cost_kernel_matches_twin_on_gpu():
    """K5, every variant, against the twin on the card: within 2e-5 of
    max(1, the output's max |value|) (both the reference's dot3, sums in
    another order)."""
    dev, _, KB = _gpu_probes()
    rng = np.random.default_rng(5)
    for name in KB.VARIANTS:
        args = KB.make_inputs(rng, name, 9, dev)
        got = KB.body_cost(name, *args)
        torch.cuda.synchronize()
        want = KB.body_cost_plain(name, *args)
        err = float((got - want).abs().max())
        assert err <= 2e-5 * max(1.0, float(want.abs().max())), (name, err)
