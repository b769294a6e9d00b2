"""surround360_tpu_torch — the Surround360 stereo renderer in PyTorch + CUDA.

A port of the JAX package ``surround360_tpu`` (which stays the reference)
to PyTorch on an NVIDIA Hopper GPU. The sub-packages mirror the reference:

- ``geometry``  — camera model and rig descriptions (host float64 numpy).
- ``ops``       — resize / filters / compositing / remap / window samplers,
                  and ``fused_window``: the hand-written CUDA windowed
                  samplers (``csrc/``) that replace the reference's Pallas
                  kernel, with their plain PyTorch twins.
- ``flow``      — pyramidal patch-match optical flow, every preset.
- ``views``     — flow-based novel-view synthesis.
- ``render``    — the stereo panorama renderer (equirect and cubemap), pole
                  removal, the per-stage time table.
- ``isp``       — raw conversion, .bin footage, DNG, and the software ISP.
- ``native``    — the C++ footage IO (built with g++ at first use).
- ``capture``   — the capture simulator (inputs and analytic truth).
- ``cli``       — ``run_all`` (unpack -> render -> encode), ``unpack``,
                  ``raw2rgb``, the video renderer ``render_video``, PNG io.
- ``benchmarks`` — the kernel probes (their CUDA kernels in ``csrc/``) and
                  the preset, profile, flow-quality and grid harnesses.
- ``cuda_build`` — nvcc of every ``csrc/*.cu`` at first use.

Device tensors are ``torch.Tensor`` on the device of their inputs; host
geometry stays float64 numpy. The package never imports ``jax``.
"""

__version__ = "0.1.0"
