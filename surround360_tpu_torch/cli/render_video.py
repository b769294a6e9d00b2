"""Quality presets of the video renderer.

Port of the preset tables of ``surround360_tpu/cli/render_video.py``
(scripts/batch_process_video.py:176-199). The frame loop itself (state
save/resume, writer thread) is not ported yet.
"""

from __future__ import annotations

QUALITY_PRESETS = {
    # name -> (eqr_width, eqr_height, final_width, final_height); the final
    # height counts BOTH stacked eyes
    "3k": (3080, 1540, 3080, 3080),
    "4k": (4200, 1024, 4096, 2048),
    "6k": (6300, 3072, 6144, 6144),
    "8k": (8400, 4096, 8192, 8192),
    "preview": (1008, 504, 1008, 1008),
}

# every reference quality preset sharpens at 0.25
# (batch_process_video.py:177,183,189,195)
PRESET_SHARPENING = 0.25

# side pair flows on overlaps downscaled by this factor at large presets
# (RenderConfig.side_flow_scale)
PRESET_SIDE_FLOW_SCALE = {"6k": 0.5, "8k": 0.5}
