"""One intra-op thread for torch in the port's CPU tests.

The test suite runs in several worker processes at once, and torch's
default (one OpenMP thread per core, which spin while they wait) then
oversubscribes the cores many times over: with six busy processes on
eight cores a test of the port took 171 s instead of 10 s, and it slows
every other worker's tests as well. Each test module of the port imports
this autouse fixture; the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
