"""A cell of ``BENCHMARK.json`` cut to a size the CPU can render: the rig
with 256 px cameras, 280x140 per eye, a 252x252 final stereo frame, and a
pool of 3 frames; ``render`` overrides the render preset's fields."""

from __future__ import annotations

import copy

from s360bench.run import Cell, resolve

CAMERA_PX = 256


def tiny_cell(name: str = "video_6k", **render) -> Cell:
    cell = copy.deepcopy(resolve(name))
    rig = cell.config["rig"]
    rig["side_resolution"] = rig["fisheye_resolution"] = [CAMERA_PX, CAMERA_PX]
    cell.config["render"].update({**dict(eqr_width=280, eqr_height=140, final_eqr_width=252,
                                         final_eqr_height=252), **render})
    cell.traffic["pool_frames"] = 3
    return cell
