"""What the benchmark loads: no JAX and no JAX package anywhere, and
nothing of the program in the reference. Module names are compared by
their whole top-level name, so ``surround360_tpu_torch`` is not
``surround360_tpu``."""

import os
import shutil
import subprocess
import sys

from s360bench.run import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "surround360_tpu"}


def _top_level_after(code: str) -> set:
    probe = code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "JAX_PLATFORMS": ""})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_path_loads_no_jax():
    names = _top_level_after(
        "import glob, os\n"
        "import s360bench.run as r, s360bench.program, s360bench.check, s360bench.trace\n"
        "import s360bench.bounds, s360bench.feed, s360bench.reference.system\n"
        "import s360bench.faults, s360bench.readings\n"
        "import surround360_tpu_torch.render.panorama, surround360_tpu_torch.isp.pipeline\n"
        "import surround360_tpu_torch.ops.fused_window\n"
        "for f in glob.glob('s360bench/metrics/*.py'):\n"
        "    r.metric_reader(os.path.basename(f)[:-3])\n")
    assert "surround360_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = _top_level_after(
        "import glob, importlib, os\n"
        "for f in glob.glob('s360bench/reference/*.py'):\n"
        "    importlib.import_module('s360bench.reference.' + os.path.basename(f)[:-3])\n"
        "import s360bench.feed, s360bench.scene, s360bench.bounds, s360bench.check\n")
    assert not names & (FORBIDDEN | {"surround360_tpu_torch"})


def test_forbidden_names_are_whole_top_level_names():
    from s360bench.run import FORBIDDEN as harness

    assert set(harness) == FORBIDDEN
    assert "surround360_tpu_torch".split(".")[0] not in harness


def test_fails_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder prints
    no result and exits with another code than 0."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "s360bench"), tmp_path / "s360bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "s360bench.run", "--workload", "video_6k",
                        "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
