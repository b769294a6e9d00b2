"""The plain reference of the benchmark: plain PyTorch and numpy, with no
import of the program or of the JAX package.

A frozen copy of the port's float32 path as it stood when the benchmark
was defined (the rig and lens model, the static warps, the flow presets,
novel views, poles, sharpening and resize, the ISP), with the program's
hand kernels replaced by plain tap gathers (``taps.py``). Each of the
program's windows is part of its result (a tap beyond a window reads
nothing), so the reference plans the same windows. A later change to the
program is held to this copy; the copy is not edited.
"""
