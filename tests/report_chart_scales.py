"""Report: what the reference's and the port's chart detectors return as
the chart shrinks or grows in a 2048 px frame. On the CPU.

    python tests/report_chart_scales.py

tests/test_calib_color.py's chart (its MacBeth colours, 36 px patches and
10 px separators at 1.0x) rotated 5 degrees with noise 0.01
(chip_smoke.render_chart), at several scales: the number of patches each
detector returns, or its error. The reference also returns the chart's
outline where the chart is small (its 25th "patch"), which the port drops.
Needs the JAX package and OpenCV (the reference's detector).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from surround360_tpu.calib import color as J  # noqa: E402
from surround360_tpu_torch.calib import color as C  # noqa: E402

SCALES = (1.0, 1.5, 2.0, 2.5, 3.2)


def count(detect, img):
    try:
        return str(len(detect(img)[0]))
    except ValueError as e:
        return f"ValueError ({e})"


def main():
    colors = np.clip(cs.lab_to_rgb(C.LAB_MACBETH["D50"]), 0.03, 1.0)
    for scale in SCALES:
        img, _ = cs.render_chart(colors, 2048, scale, rotation_deg=5.0, noise=0.01, seed=4)
        print(f"scale {scale}x: reference {count(J.detect_color_chart, img)}, port "
              f"{count(lambda a: C.detect_color_chart(a, device='cpu'), img)}", flush=True)


if __name__ == "__main__":
    main()
