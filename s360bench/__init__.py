"""The benchmark of ``surround360_tpu_torch`` on one NVIDIA GPU (see
``README.md``)."""
