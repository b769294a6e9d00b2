"""The precision control on the card: the reference in TF32 in the
program's place fails the cell's limits. At 1024 px cameras and the 3k
preset's 3080x1540 per eye, so that a test run holds it; the limits are
the 6k cell's."""

import pytest

from s360bench.reference.system import Reference
from s360bench.run import result_line, run_cell
from s360bench.tests.tiny import tiny_cell


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_tf32_control_is_not_correct(cuda, seed):
    cell = tiny_cell("video_6k")
    cell.config["rig"]["side_resolution"] = cell.config["rig"]["fisheye_resolution"] = [1024, 1024]
    cell.config["render"].update(eqr_width=3080, eqr_height=1540, final_eqr_width=3080,
                                 final_eqr_height=3080)
    make = lambda config, device: Reference(config, device, tf32=True)  # noqa: E731
    r = run_cell(cell, seed, 3.0, False, cuda, make_system=make)
    assert result_line(cell, r, False, {"platform": "gpu"})["correct"] is False
