"""A fixture for the port's calibration tests: they run thousands of small
CPU ops (the ORB stages a pyramid level at a time, the LM iterations), and
the suite runs test files in several worker processes at once. With
PyTorch's default of one intra-op thread a core in every worker, those ops
wait on an oversubscribed thread pool and slow every other worker too;
one thread a worker keeps them near their single-process time.

    from torch_threads import one_torch_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
