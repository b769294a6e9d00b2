"""The benchmark folder on the card: the two kernel probes (K4
``kernel_step_cost``, K5 ``kernel_body_cost``) and the harnesses
``profile_stages``, ``preset_table``, ``preset_quality``, ``flow_quality``
and ``trace_grid_economics``. Run each as
``python -m surround360_tpu_torch.benchmarks.<name> [--device cpu]``."""
