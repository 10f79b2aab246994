"""Shared fixture of the port's CPU tests (tests/test_torch_*.py).

The port runs eagerly: a solve at test size is tens of thousands of ops on
tensors of a few hundred elements, for which torch's intra-op thread pool
costs far more than it saves, the more so with several test workers on one
host (one n = 300 `lm_solve` ran some 17 times faster on one thread than
on eight).
Importing `one_torch_thread` into a test module runs that module on one
thread and restores the previous count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
