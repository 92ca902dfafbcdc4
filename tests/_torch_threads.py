"""One intra-op thread for the port's CPU tests.

The tests run in several worker processes at once (pytest-xdist); torch's
default of one thread per core in each of them oversubscribes the CPU so
badly that a 2-second test takes minutes. A test module of the port
imports `one_torch_thread`, an autouse fixture, to run on one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
